"""Step builders: training (with gradient accumulation over microbatches)
and prefill — the port of `repro/runtime/train_step.py` for the paper's
tiny model and every scaled family (dense, MoE, VLM, SSM, hybrid,
audio). The
wireless mode is woven in here: SL routes the forward through the split +
channel link (core/split.py); CL with a noisy link corrupts the tiny
model's raw uplink tokens. FL wraps these in runtime/fl_runtime.py.

Gradients come from autograd: a step differentiates detached copies of
the trainable tree's leaves (`torch.autograd.grad`) and applies the
plain-tensor optimizer update (optim/sgd.py, optim/adamw.py), in the
JAX step's order. There is no mesh, so the sharding helpers of the JAX
module (`trainable_axes`, `train_state_axes`, `axes_to_shardings`,
`train_state_sds_and_shardings`, `key_sds`) are still to port
(ROADMAP.md, P16).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import centralized
from repro_torch.core.split import init_codec, split_forward
from repro_torch.models import api as M
from repro_torch.models import lstm_tiny
from repro_torch.nn import init_tree, tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw, sgd_momentum

MOE_AUX_COEF = 0.01
TRAINED_FAMILIES = ("tiny", "dense", "moe", "vlm", "ssm", "hybrid",
                    "audio")


class TrainState(NamedTuple):
    trainable: Any          # {"model": params, "codec": codec-or-{}}
    opt_state: Any
    step: int


def _check_family(cfg) -> None:
    if cfg.family not in TRAINED_FAMILIES:
        raise ValueError(
            f"training: unknown family {cfg.family!r}; the port trains "
            f"{list(TRAINED_FAMILIES)}")


def _optimizer(optimizer: str, momentum: float = 0.9):
    if optimizer == "adamw":
        return adamw()
    if optimizer == "sgd":
        return sgd_momentum(momentum)
    raise ValueError(f"unknown optimizer {optimizer!r} (adamw|sgd)")


def window_for(cfg, shape_cfg) -> int:
    """long_500k needs sub-quadratic attention: attention families run a
    sliding window; SSM/hybrid are natively O(1)-state."""
    if shape_cfg.name == "long_500k" and cfg.family in ("dense", "moe",
                                                        "vlm", "audio"):
        return 8192
    return 0


# data shards of the JAX package's production mesh, which the last rule
# of `auto_microbatch` divides the batch by (the port has no mesh yet:
# ROADMAP.md, P16)
N_DATA_SHARDS = 16


def auto_microbatch(cfg, shape_cfg) -> int:
    """Number of grad-accumulation microbatches: the shape's override,
    then the arch's microbatch_size, then one sample per data shard."""
    if shape_cfg.microbatch:
        return shape_cfg.global_batch // shape_cfg.microbatch
    if cfg.microbatch_size and shape_cfg.global_batch > cfg.microbatch_size:
        return shape_cfg.global_batch // cfg.microbatch_size
    return max(1, shape_cfg.global_batch // N_DATA_SHARDS)


def _forward(trainable, batch, cfg, wcfg, key, window: int = 0):
    if wcfg is not None and wcfg.mode == "sl":
        return split_forward(trainable["model"], trainable["codec"], batch,
                             cfg, wcfg, key, window)
    return M.get_model(cfg).forward(trainable["model"], batch, cfg, window)


def _loss(trainable, batch, cfg, wcfg, key, window: int = 0):
    logits, aux = _forward(trainable, batch, cfg, wcfg, key, window)
    if cfg.family == "tiny":
        loss = lstm_tiny.bce_loss(logits, batch["labels"])
        metrics = {"loss": loss,
                   "accuracy": lstm_tiny.accuracy(logits, batch["labels"])}
    else:
        loss = M.lm_loss(logits, batch, cfg)
        metrics = {"loss": loss}
    metrics["aux_loss"] = aux["aux_loss"]
    return loss + MOE_AUX_COEF * aux["aux_loss"], metrics


def value_and_grad(trainable, batch, cfg, wcfg, key, window: int = 0):
    """(metrics, grads) of `_loss` at `trainable` (grads shaped like
    it); the tree itself is left untouched."""
    leaves = [l.detach().requires_grad_() for l in tree_leaves(trainable)]
    total, metrics = _loss(tree_unflatten(trainable, leaves), batch, cfg,
                           wcfg, key, window)
    grads = torch.autograd.grad(total, leaves)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(trainable, list(grads)))


def make_local_step(cfg, lr, momentum: float = 0.9, prox_mu: float = 0.0,
                    anchor=None):
    """ONE plain SGD+momentum step of `_loss` — the FL local-phase core
    of the tiny round and the scaled FL step. FL local steps are
    radio-free (only the sync crosses the channel). With prox_mu > 0 it
    becomes FedProx (Li et al. 2020): grad += mu * (w - anchor) over the
    trainable tree, `anchor` shaped like it.
    local_step(state, batch, key=None) -> (state, metrics)."""
    _, opt_update = sgd_momentum(momentum)

    def local_step(state: TrainState, batch: dict, key=None):
        metrics, g = value_and_grad(state.trainable, batch, cfg, None, key)
        if prox_mu and anchor is not None:
            g = tree_map(lambda gi, wi, ai: gi + prox_mu * (wi - ai),
                         g, state.trainable, anchor)
        trainable, opt_state = opt_update(g, state.opt_state,
                                          state.trainable, lr)
        return TrainState(trainable, opt_state, state.step + 1), metrics

    return local_step


def init_train_state(generator: torch.Generator, cfg, wcfg=None,
                     optimizer: str = "adamw", momentum: float = 0.9,
                     device="cuda") -> TrainState:
    """Model (+ SL codec) params drawn from `generator` on `device` in the
    trainable layout (`models.api.train_param_specs`), and the
    optimizer's zero state."""
    _check_family(cfg)
    opt_init, _ = _optimizer(optimizer, momentum)
    params = init_tree(M.train_param_specs(cfg), generator, device)
    codec = (init_codec(generator, cfg, wcfg, device)
             if (wcfg is not None and wcfg.mode == "sl") else {})
    trainable = {"model": params, "codec": codec}
    return TrainState(trainable, opt_init(trainable), 0)


def make_train_step(cfg, shape_cfg, wcfg=None, optimizer: str = "adamw",
                    lr: float = 3e-4, momentum: float = 0.9):
    """Returns train_step(state, batch, key[, lr]) -> (state, metrics):
    gradients summed over `auto_microbatch` microbatches in float32
    accumulators (microbatch i on key.fold_in(i)), divided by their
    count, then one optimizer update. `key` is a `core.draws.Key`; the
    SL link draws from it."""
    _check_family(cfg)
    window = window_for(cfg, shape_cfg)
    n_micro = auto_microbatch(cfg, shape_cfg)
    _, opt_update = _optimizer(optimizer, momentum)

    def train_step(state: TrainState, batch: dict, key, lr=lr):
        if wcfg is not None and wcfg.mode == "cl" \
                and not wcfg.perfect_channel and cfg.family == "tiny":
            batch, _ = centralized.upload_batch(key.draws(), batch,
                                                cfg.vocab_size, wcfg)
        g_acc = m_acc = None
        for i in range(n_micro):
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            metrics, g = value_and_grad(state.trainable, mb, cfg, wcfg,
                                        key.fold_in(i), window)
            if g_acc is None:
                g_acc = tree_map(lambda b: torch.zeros_like(b) + b.float(),
                                 g)
                m_acc = {k: torch.zeros_like(v) + v
                         for k, v in metrics.items()}
            else:
                g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
                m_acc = {k: m_acc[k] + v for k, v in metrics.items()}
            del g
        grads = tree_map(lambda g: g / n_micro, g_acc)
        del g_acc
        metrics = {k: v / n_micro for k, v in m_acc.items()}
        trainable, opt_state = opt_update(grads, state.opt_state,
                                          state.trainable, lr)
        return TrainState(trainable, opt_state, state.step + 1), metrics

    return train_step


def make_prefill_step(cfg, shape_cfg, wcfg=None):
    """Inference prefill: full forward, returns last-token logits."""
    window = window_for(cfg, shape_cfg)

    def prefill(trainable, batch, key):
        logits, _ = _forward(trainable, batch, cfg, wcfg, key, window)
        return logits[:, -1]

    return prefill
