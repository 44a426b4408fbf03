"""Federated learning (paper Alg. 1) — the port of
`repro/core/federated.py`: N users, J local SGD steps each, quantized
weight upload through the Rayleigh/AWGN channel, FedAvg (Eq. 3),
broadcast back. User replicas live in a leading axis of the param tree;
the local phase loops over users (each user's J steps in order). The
aggregate is FedAvg's mean or the coordinate-wise median
(`wcfg.aggregate`)."""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.core import wire as W
from repro_torch.nn import tree_leaves, tree_map


def replicate_for_users(params, n_users: int):
    return tree_map(lambda p: p.expand((n_users,) + tuple(p.shape)), params)


def _map_state(fn, state, *rest):
    """`fn` over the tensor leaves of TrainStates (trainable params and
    optimizer velocity); the step counters, equal for every user, are
    kept from `state`."""
    trainable = tree_map(fn, state.trainable,
                         *(r.trainable for r in rest))
    vel = tree_map(fn, state.opt_state.velocity,
                   *(r.opt_state.velocity for r in rest))
    return type(state)(trainable, state.opt_state._replace(velocity=vel),
                       state.step)


def user_slice(state, u: int):
    """User u's TrainState out of a user-stacked one."""
    return _map_state(lambda a: a[u], state)


def stack_users(states: list):
    """Stack per-user TrainStates along a leading user axis."""
    return _map_state(lambda *xs: torch.stack(xs), states[0], *states[1:])


def broadcast_state(state, n_users: int):
    """A TrainState replicated for `n_users` users."""
    return _map_state(lambda p: p.expand((n_users,) + tuple(p.shape)),
                      state)


def fedavg_through_channel(draws, user_params, wcfg):
    """user_params: tree with leading user axis [N, ...]. One packed
    stacked send (one packet per (user, tensor)), FedAvg (Eq. 3),
    broadcast back. Returns (global params [N, ...], total
    payload bits as float, billed at the analytic expected ARQ count)."""
    n_users = tree_leaves(user_params)[0].shape[0]
    received = W.transmit_stacked(
        draws, user_params, bits=wcfg.quant_bits, snr_db=wcfg.snr_db,
        fading=wcfg.fading, perfect=wcfg.perfect_channel,
        arq_attempts=wcfg.arq_attempts, arq_min_f2=wcfg.arq_min_f2)
    avg = tree_map(aggregator(wcfg.aggregate), received)
    e_tx = W.expected_arq_tx(wcfg.arq_attempts, wcfg.arq_min_f2,
                             wcfg.fading, wcfg.perfect_channel)
    total_bits = W.payload_bits(user_params, wcfg.quant_bits, e_tx)
    return replicate_for_users(avg, n_users), total_bits


def mean_users(r: torch.Tensor) -> torch.Tensor:
    """FedAvg's mean over the leading user axis as the JAX package
    computes it: users summed in ascending order, times the float32
    reciprocal of their count (XLA's form of the division)."""
    acc = r[0]
    for u in range(1, r.shape[0]):
        acc = acc + r[u]
    return acc * Q.f32_reciprocal(r.shape[0])


def median_users(r: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the leading user axis as `jnp.median`
    computes it: the mean of the two middle values for an even count,
    (lo + hi) * 0.5 (`torch.median` would return the lower one)."""
    s = torch.sort(r, dim=0).values
    n = r.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def aggregator(name: str):
    """The user-axis reduction of `WirelessConfig.aggregate`."""
    if name == "mean":
        return mean_users
    if name == "median":
        return median_users
    raise ValueError(f"unknown aggregate {name!r}")


def local_steps_vmapped(step_fn, user_state, user_batches):
    """J local steps per user: user u's state is slice u of the stacked
    state, its batches slice u of `user_batches` (leaves [N, J, ...]).
    step_fn(state, batch) -> (state, metrics). Returns (stacked states,
    metrics stacked [N, J])."""
    n, j = next(iter(user_batches.values())).shape[:2]
    states, mets = [], []
    for u in range(n):
        st = user_slice(user_state, u)
        row = []
        for t in range(j):
            st, m = step_fn(st, {k: v[u, t]
                                 for k, v in user_batches.items()})
            row.append(m)
        states.append(st)
        mets.append({k: torch.stack([m[k] for m in row]) for k in row[0]})
    return stack_users(states), {k: torch.stack([m[k] for m in mets])
                                 for k in mets[0]}
