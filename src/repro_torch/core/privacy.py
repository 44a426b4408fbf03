"""Privacy evaluation (paper Sec. II-E, Eq. 12) — the port of
`repro/core/privacy.py`. An adversary trained WITH access to raw inputs
(the paper's strong-adversary assumption) tries to reconstruct the
normalized raw input from what crossed the radio:

  CL -> the received (bit-error-corrupted) raw tokens          (direct)
  FL -> the received quantized weight DELTA of a user's update
  SL -> the received compressed smashed activations

Error = mean squared error on normalized inputs (Eq. 12). The paper
reports SL ~4x FL and ~18x CL.

The adversary is a 3-layer MLP trained with AdamW on `device` (the card
by default). Its two random draws, the initial weights and each step's
batch indices, go through `AdversaryDraws`, so a caller can hand in
another implementation's draws (the parity tests hand in the JAX
package's) and the card and the CPU can train from the same ones.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.draws import seeded
from repro_torch.nn import (Spec, init_tree, resolve_device, tree_leaves,
                            tree_unflatten)
from repro_torch.optim import adamw


def normalize_tokens(tokens, vocab: int) -> torch.Tensor:
    """Paper: 'normalization of the data is applied'."""
    return torch.as_tensor(tokens).float() / float(vocab)


def mlp_specs(d_in: int, d_hidden: int, d_out: int) -> dict:
    return {
        "w1": Spec((d_in, d_hidden), (None, None), init="fan_in"),
        "b1": Spec((d_hidden,), (None,), init="zeros"),
        "w2": Spec((d_hidden, d_hidden), (None, None), init="fan_in"),
        "b2": Spec((d_hidden,), (None,), init="zeros"),
        "w3": Spec((d_hidden, d_out), (None, None), init="fan_in"),
        "b3": Spec((d_out,), (None,), init="zeros"),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


class AdversaryDraws:
    """The adversary's random numbers from `seed`, on CPU generators (the
    same on every device): `init` its weights, `indices` step i's batch
    rows."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def init(self, specs: dict, device) -> dict:
        return init_tree(specs, torch.Generator().manual_seed(self.seed),
                         device)

    def indices(self, step: int, size: int, n: int) -> torch.Tensor:
        return torch.randint(0, n, (size,),
                             generator=seeded(self.seed, 1, step).generator)


def reconstruction_error(draws, observations: np.ndarray,
                         targets: np.ndarray, d_hidden: int = 256,
                         steps: int = 400, batch: int = 256,
                         lr: float = 1e-3, test_frac: float = 0.2,
                         device="cuda") -> float:
    """Train the adversary decoder obs -> target on all but the last
    `test_frac` of the rows; return its held-out MSE (Eq. 12).
    observations [N, ...] and targets [N, ...] are numpy arrays; `draws`
    is an `AdversaryDraws` (or anything with its `init` and `indices`)."""
    dev = resolve_device(device)
    obs = torch.from_numpy(np.asarray(observations, np.float32).reshape(
        len(observations), -1)).to(dev)
    tgt = torch.from_numpy(np.asarray(targets, np.float32).reshape(
        len(targets), -1)).to(dev)
    n_test = max(1, int(len(obs) * test_frac))
    obs_tr, obs_te = obs[:-n_test], obs[-n_test:]
    tgt_tr, tgt_te = tgt[:-n_test], tgt[-n_test:]
    params = draws.init(mlp_specs(obs.shape[-1], d_hidden, tgt.shape[-1]),
                        dev)
    opt_init, opt_update = adamw(weight_decay=0.0)
    state = opt_init(params)
    n = len(obs_tr)
    for i in range(steps):
        idx = draws.indices(i, min(batch, n), n).to(dev)
        leaves = [l.detach().requires_grad_() for l in tree_leaves(params)]
        pred = mlp(tree_unflatten(params, leaves), obs_tr[idx])
        loss = torch.mean(torch.square(pred - tgt_tr[idx]))
        grads = tree_unflatten(params,
                               list(torch.autograd.grad(loss, leaves)))
        params, state = opt_update(grads, state, params, lr)
    with torch.no_grad():
        return float(torch.mean(torch.square(mlp(params, obs_te) - tgt_te)))


def direct_error(received_norm: np.ndarray, targets_norm: np.ndarray) -> float:
    """CL case: the adversary just reads the received raw data."""
    return float(np.mean(np.square(received_norm - targets_norm)))
