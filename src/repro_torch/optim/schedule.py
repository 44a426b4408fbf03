"""LR schedules — the port of `repro/optim/schedule.py`. The paper
reduces the LR by 10% every 5 epochs."""
from __future__ import annotations


def step_decay(base_lr: float, decay: float = 0.9, every: int = 5):
    """lr = base * decay**(epoch // every)."""

    def lr(epoch):
        return base_lr * decay ** (epoch // every)

    return lr


def constant(base_lr: float):
    return lambda step: base_lr
