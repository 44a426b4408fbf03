"""SGD with momentum, exactly the paper's update rule (Eq. 13-14) — the
port of `repro/optim/sgd.py`:

    v_{t+1} = mu * v_t + eta * grad
    w_{t+1} = w_t - v_{t+1}

The learning rate multiplies the *gradient* inside the velocity (the
Keras/paper convention). Plain tensor updates over a parameter tree in
JAX's order of operations, not `torch.optim`: each product is rounded
before the add, as XLA evaluates `momentum * v + lr * g`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.nn.core import tree_map


class SGDState(NamedTuple):
    velocity: Any
    step: int


def sgd_momentum(momentum: float = 0.9):
    def init(params):
        return SGDState(tree_map(torch.zeros_like, params), 0)

    def update(grads, state: SGDState, params, lr):
        v = tree_map(lambda v, g: momentum * v + lr * g,
                     state.velocity, grads)
        new_params = tree_map(lambda w, v: w - v, params, v)
        return new_params, SGDState(v, state.step + 1)

    return init, update
