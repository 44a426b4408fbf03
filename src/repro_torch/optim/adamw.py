"""AdamW — the port of `repro/optim/adamw.py`, in its order of
operations on a plain parameter tree (float32 tensors):

    mu = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
    w  = w - lr (mu / bc1 / (sqrt(nu / bc2) + eps) + wd w)

with bc = 1 - b^step in float32. The privacy adversary
(core/privacy.py) trains with it."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.nn.core import tree_map


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
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g * g, state.nu,
                      grads)
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t

        def upd(w, m, n):
            mhat = m / bc1.to(m.device)
            nhat = n / bc2.to(n.device)
            return w - lr * (mhat / (torch.sqrt(nhat) + eps)
                             + weight_decay * w)

        return tree_map(upd, params, mu, nu), AdamWState(mu, nu, step)

    return init, update
