"""AdamW — the port of `repro/optim/adamw.py`, in its order of
operations on a plain parameter tree (float32 tensors):

    mu = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
    w  = w - lr (mu / bc1 / (sqrt(nu / bc2) + eps) + wd w)

with bc = 1 - b^step in float32. The privacy adversary
(core/privacy.py) trains with it.

`update` writes mu, nu and the weights in place, leaf by leaf: the
port's counterpart of the JAX step's donated state, which XLA updates
in its own buffers. The caller hands over `params` and `state` (they
come back as the result, the same tensors) and clones first whatever
it reads afterwards. Each product and sum above is its own rounded
operation, as in the functional expression: no `add_(x, alpha=a)`,
which may fuse into one FMA on the card. The temporaries are at most
two of one leaf's size, never a whole tree's; `grads` is only read."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.nn.core import tree_leaves, tree_map


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    step: int


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    def init(params):
        return AdamWState(tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params), 0)

    def update(grads, state: AdamWState, params, lr):
        step = state.step + 1
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        for w, m, n, g in zip(tree_leaves(params), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(grads)):
            m.mul_(b1).add_(g * (1 - b1))
            a = g * (1 - b2)
            n.mul_(b2).add_(a.mul_(g))
            torch.div(m, bc1.to(m.device), out=a)             # mhat
            d = torch.div(n, bc2.to(n.device))                # nhat
            a.div_(d.sqrt_().add_(eps))
            a.add_(torch.mul(w, weight_decay, out=d))
            w.sub_(a.mul_(lr))
        return params, AdamWState(state.mu, state.nu, step)

    return init, update
