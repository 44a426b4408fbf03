"""Shared plumbing of the CL/FL/SL schemes — the port of
`repro/schemes/base.py`:

    scheme = build_scheme(wcfg)                  # schemes/run.py
    state, first = scheme.init(seed, xtr, ytr)   # params (+CL data upload)
    batch = scheme.cycle_batches(state, rng, k)  # paradigm's cycle data
    state, report = scheme.round(state, batch, key, lr)
    acc = scheme.evaluate(state, xte, yte)

One `round` is one communication cycle: a training epoch for CL/SL, the
J-local-epochs + quantized-upload + FedAvg exchange for FL. Every radio
crossing goes through the scheme's `Radio` and is billed into the
`RoundReport`. Keys are `core.draws.Key`s in the JAX package's fold
structure; the data rng is numpy's, as there.

FLOPs: the JAX package counts the dot FLOPs of the compiled step from
its HLO; the port computes the same count in closed form from the tiny
model's shapes (`step_flops`, `user_side_flops_sl`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.sentiment import make_splits
from repro_torch.models import lstm_tiny as LT

CFG = get_arch("paper-tinylstm")
BATCH = 512                      # paper Table I
# Paper Table I: lr=0.01, SGD+momentum 0.9; the reduced corpus gives
# ~50x fewer steps, so the LR is scaled x10 (the JAX package's choice);
# the schedule shape (x0.9 every 5 epochs) is the paper's.
LR0 = 0.1
MOMENTUM = 0.9
LR_DECAY, LR_EVERY = 0.9, 5      # "reduce by 10% every 5 epochs"

# Reduced-corpus defaults (paper: 1.44M train / 160k test).
N_TRAIN = 24_576
N_TEST = 2_560


def lr_at(epoch: int) -> float:
    return LR0 * LR_DECAY ** (epoch // LR_EVERY)


def train_shape(batch: int = BATCH) -> ShapeConfig:
    return ShapeConfig("paper", LT.SEQ, batch, "train", microbatch=batch)


# --------------------------------------------------------------------- data
@functools.lru_cache(maxsize=4)
def corpus(n_train: int = N_TRAIN, n_test: int = N_TEST, seed: int = 0):
    (xtr, ytr), (xte, yte) = make_splits(
        n_train + n_test, seed=seed, train_frac=n_train / (n_train + n_test))
    return (xtr, ytr), (xte, yte)


def batches_of(x: np.ndarray, y: np.ndarray, batch: int,
               rng: np.random.Generator, device="cpu"):
    """Shuffled full batches as tensors on `device` (the JAX package's
    permutation stream)."""
    idx = rng.permutation(len(x))
    n = len(x) // batch
    for i in range(n):
        s = idx[i * batch:(i + 1) * batch]
        yield {"tokens": torch.from_numpy(x[s]).to(device),
               "labels": torch.from_numpy(y[s]).to(device)}


# ------------------------------------------------------------------- cycle
def train_cycle(step, train_state, batches, key, steps: int, on_step=None):
    """One client's training cycle: every batch through `step`, per-step
    keys folded from the client's CUMULATIVE step counter. Returns
    (state, last_metrics, steps)."""
    m = None
    for b in batches:
        kb = key.fold_in(steps)
        train_state, m = step(train_state, b, kb)
        if on_step is not None:
            on_step(steps, train_state, b, kb)
        steps += 1
    return train_state, m, steps


# --------------------------------------------------------------------- eval
@torch.no_grad()
def evaluate(params, xte, yte, batch: int = 2048):
    """(accuracy, loss) of `params` over whole batches of the test set
    (the whole set when it is smaller than one batch)."""
    dev = params["embed"].device

    def ev(x, y):
        tokens = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        labels = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
        logits, _ = LT.forward(params, {"tokens": tokens})
        return (float(LT.accuracy(logits, labels)),
                float(LT.bce_loss(logits, labels)))

    accs, losses = [], []
    for i in range(0, len(xte) - batch + 1, batch):
        a, l = ev(xte[i:i + batch], yte[i:i + batch])
        accs.append(a)
        losses.append(l)
    if not accs:
        return ev(xte, yte)
    return float(np.mean(accs)), float(np.mean(losses))


# -------------------------------------------------------------------- FLOPs
def _dot(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def _conv_flops(b: int) -> int:
    t = LT.SEQ - LT.CONV_K + 1
    return LT.CONV_K * _dot(b * t, LT.EMBED, LT.CONV_F)


def _codec_flops(b: int, compress_factor: int) -> int:
    c = max(1, LT.CONV_F // compress_factor)
    t = (LT.SEQ - LT.CONV_K + 1) // 2
    return _dot(b * t, LT.CONV_F, c)


def step_flops(mode: str, compress_factor: int = 4) -> float:
    """Dot FLOPs of one batch-512 fwd+bwd train step, in closed form:
    the count the JAX package reads from its compiled step's HLO. Every
    dot costs 2mkn; the backward pass repeats each forward dot twice
    (input and weight gradients), except the output layer's input
    gradient, a contraction over size 1 that XLA does not lower as a
    dot. SL adds the codec's encoder and decoder."""
    b = BATCH
    t_pool = (LT.SEQ - LT.CONV_K + 1) // 2
    fwd = (_conv_flops(b)
           + t_pool * 2 * _dot(b, LT.CONV_F, 4 * LT.LSTM_H)
           + _dot(b, LT.LSTM_H, LT.DENSE) + _dot(b, LT.DENSE, 1))
    total = 3 * fwd - _dot(b, LT.DENSE, 1)
    if mode == "sl":
        total += 3 * 2 * _codec_flops(b, compress_factor)
    return float(total)


def user_side_flops_sl(compress_factor: int = 4) -> float:
    """SL user-side dot FLOPs per batch: conv fwd + semantic encode,
    each with both gradients (3x)."""
    b = BATCH
    return float(3 * (_conv_flops(b) + _codec_flops(b, compress_factor)))


# ------------------------------------------------------------------ results
@dataclasses.dataclass
class RunResult:
    accuracy: list          # per-cycle test accuracy
    loss: list              # per-cycle train loss
    total_bits: float       # payload that crossed the radio
    user_flops: float       # user-side computation (fwd+bwd share)
    server_flops: float
    captures: dict          # privacy-eval observations (capture=True)

    @property
    def final_accuracy(self) -> float:
        return float(np.mean(self.accuracy[-3:])) if self.accuracy else 0.0


@dataclasses.dataclass
class ClientReport:
    """One client's slice of a population round
    (schemes/population.py): `bits` / `n_tx` / `energy_j` crossed THIS
    client's own Radio; `weight` is its sample-count aggregation weight,
    renormalized over the round's participants (0 for a client that sat
    the round out). `status`: "ok", "sampled_out" (the participation
    policy left it out), "straggler" (its estimated round time passed
    the deadline), "erased" (a FaultPlan outage, or its upload erased
    under bounded ARQ) or "dropped_midround" (a FaultPlan death part of
    the way through its upload). `est_round_s` is the deadline model's
    estimate; `erased_bits` the attempted-but-undelivered slice of
    `bits`."""
    name: str
    paradigm: str           # "fl" | "sl" | "cl"
    loss: float
    steps: int              # optimizer steps this client took this round
    bits: float = 0.0
    n_tx: float = 0.0
    energy_j: float = 0.0
    weight: float = 0.0
    status: str = "ok"
    est_round_s: float = 0.0
    erased_bits: float = 0.0


@dataclasses.dataclass
class RoundReport:
    """Accounting of ONE communication cycle: `n_tx` is the DRAWN
    transmission count (the fused SL path replays its per-step draws,
    `split.sl_cycle_drawn_diag`). For a population round the fields are
    fleet totals (`loss` the weighted mean) and `clients` holds one
    `ClientReport` per client in population order."""
    loss: float
    steps: int
    bits: float = 0.0
    n_tx: float = 0.0
    energy_j: float = 0.0
    metrics: dict = dataclasses.field(default_factory=dict)
    clients: tuple = ()
    erased_bits: float = 0.0
    outage_s: float = 0.0


@dataclasses.dataclass
class SchemeState:
    """Host-side state threaded through rounds."""
    train: Any              # TrainState (CL/SL) / user-stacked (FL)
    data: Any               # training data as held by the training side
    steps: int = 0          # cumulative optimizer steps (per user for FL)
    epoch: int = 0          # cumulative local epochs (drives the lr)
