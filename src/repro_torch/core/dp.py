"""Differential privacy for the FL uplink — the port of
`repro/core/dp.py` (the paper's future work: "integrate differential
privacy").

Gaussian mechanism on each user's model update BEFORE quantization and
the radio: clip the update to L2 norm C, add N(0, (sigma·C)^2). The
(epsilon, delta) reported is the single-release bound of the Gaussian
mechanism, as in the JAX package (a full accountant over the
composition is out of scope there too).

Keys are `core.draws.Key`s: user u's update draws its noise from
`key.fold_in(u).split(2)[0]` (one child stream per leaf, "normal"
draws) and crosses the channel on the second child, the JAX package's
split order, so a caller can hand in JAX's own streams.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import channel as CH
from repro_torch.nn import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.clip import global_norm


def privatize_update(key, delta_tree, clip_c: float, sigma: float):
    """Clip the update tree to norm C and add sigma*C Gaussian noise,
    leaf i's noise from `key.split(n_leaves)[i]`."""
    norm = global_norm(delta_tree)
    scale = torch.clamp(clip_c / torch.clamp(norm, min=1e-12), max=1.0)
    leaves = tree_leaves(delta_tree)
    keys = key.split(len(leaves))
    out = [l * scale + sigma * clip_c
           * k.draws().normal("normal", l.shape).to(l.device)
           for k, l in zip(keys, leaves)]
    return tree_unflatten(delta_tree, out)


def gaussian_epsilon(sigma: float, delta: float = 1e-5) -> float:
    """Single-release (eps, delta) of the Gaussian mechanism with noise
    multiplier sigma (classic bound, valid for eps <= 1 regime)."""
    if sigma <= 0:
        return float("inf")
    return math.sqrt(2.0 * math.log(1.25 / delta)) / sigma


def fedavg_dp_through_channel(key, user_params, broadcast, wcfg,
                              clip_c: float = 1.0, sigma: float = 0.5):
    """DP variant of `core/federated.fedavg_through_channel`: each user
    transmits a privatized DELTA (update against the cycle's broadcast)
    through its own packed-wire pass (one K1 launch per user on the
    card); the server adds the averaged delta back. The average keeps
    the JAX package's order: users summed from 0, then divided by N.
    Returns (synced params [N, ...], payload bits, epsilon)."""
    from repro_torch.core import federated as FED
    n_users = tree_leaves(user_params)[0].shape[0]
    total_bits = 0
    received = []
    for u in range(n_users):
        delta = tree_map(lambda l, b: l[u] - b, user_params, broadcast)
        kp, kc = key.fold_in(u).split(2)
        delta = privatize_update(kp, delta, clip_c, sigma)
        delta, bits = CH.transmit_pytree(kc.draws(), delta,
                                         bits=wcfg.quant_bits,
                                         snr_db=wcfg.snr_db,
                                         fading=wcfg.fading,
                                         perfect=wcfg.perfect_channel)
        received.append(delta)
        total_bits += bits
    # a true division, as JAX's eager `/ n_users` (torch on CUDA turns
    # a division by a Python scalar into a product with its reciprocal)
    avg_delta = tree_map(lambda *ds: sum(ds) / torch.full_like(ds[0],
                                                               n_users),
                         *received)
    synced = tree_map(lambda b, d: b + d, broadcast, avg_delta)
    return FED.replicate_for_users(synced, n_users), total_bits, \
        gaussian_epsilon(sigma)
