"""Train-step builders for the paper's tiny model — the tiny subset of
`repro/runtime/train_step.py`. The wireless mode is woven in here: SL
routes the forward through the split + channel link (core/split.py);
CL with a noisy link corrupts the raw uplink tokens. FL wraps these in
runtime/fl_runtime.py.

Gradients come from autograd: a step differentiates detached copies of
the trainable tree's leaves (`torch.autograd.grad`) and applies the
plain-tensor SGD update (optim/sgd.py), in the JAX step's order. The
tiny model has no mesh, so no sharding code comes along; AdamW and the
scaled families are still to port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import centralized
from repro_torch.core.split import init_codec, split_forward
from repro_torch.models import lstm_tiny
from repro_torch.nn import init_tree, tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import sgd_momentum

MOE_AUX_COEF = 0.01


class TrainState(NamedTuple):
    trainable: Any          # {"model": params, "codec": codec-or-{}}
    opt_state: Any
    step: int


def _tiny_sgd(cfg, optimizer: str) -> None:
    if cfg.family != "tiny":
        raise NotImplementedError(
            f"training family {cfg.family!r} is not ported yet; the port "
            f"trains the paper's tiny model (see ROADMAP.md, P15)")
    if optimizer != "sgd":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet; the paper's "
            f"schemes train with SGD-momentum (see ROADMAP.md, P15)")


def _forward(trainable, batch, cfg, wcfg, key):
    if wcfg is not None and wcfg.mode == "sl":
        return split_forward(trainable["model"], trainable["codec"], batch,
                             cfg, wcfg, key)
    return lstm_tiny.forward(trainable["model"], batch, cfg)


def _loss(trainable, batch, cfg, wcfg, key):
    logits, aux = _forward(trainable, batch, cfg, wcfg, key)
    loss = lstm_tiny.bce_loss(logits, batch["labels"])
    metrics = {"loss": loss,
               "accuracy": lstm_tiny.accuracy(logits, batch["labels"]),
               "aux_loss": aux["aux_loss"]}
    return loss + MOE_AUX_COEF * aux["aux_loss"], metrics


def value_and_grad(trainable, batch, cfg, wcfg, key):
    """(metrics, grads) of `_loss` at `trainable` (grads shaped like
    it); the tree itself is left untouched."""
    leaves = [l.detach().requires_grad_() for l in tree_leaves(trainable)]
    total, metrics = _loss(tree_unflatten(trainable, leaves), batch, cfg,
                           wcfg, key)
    grads = torch.autograd.grad(total, leaves)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(trainable, list(grads)))


def make_local_step(cfg, lr, momentum: float = 0.9, prox_mu: float = 0.0,
                    anchor=None):
    """ONE plain SGD+momentum step of `_loss` — the FL local-phase core.
    FL local steps are radio-free (only the sync crosses the channel).
    With prox_mu > 0 it becomes FedProx (Li et al. 2020): grad += mu *
    (w - anchor) over the trainable tree, `anchor` shaped like it.
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
                     optimizer: str = "sgd", momentum: float = 0.9,
                     device="cuda") -> TrainState:
    """Model (+ SL codec) params drawn from `generator` on `device`, and
    the optimizer's zero state."""
    _tiny_sgd(cfg, optimizer)
    params = init_tree(lstm_tiny.model_specs(cfg), generator, device)
    codec = (init_codec(generator, cfg, wcfg, device)
             if (wcfg is not None and wcfg.mode == "sl") else {})
    trainable = {"model": params, "codec": codec}
    opt_init, _ = sgd_momentum(momentum)
    return TrainState(trainable, opt_init(trainable), 0)


def auto_microbatch(shape_cfg) -> int:
    if shape_cfg.microbatch:
        return shape_cfg.global_batch // shape_cfg.microbatch
    return 1


def make_train_step(cfg, shape_cfg, wcfg=None, optimizer: str = "sgd",
                    lr: float = 3e-4, momentum: float = 0.9):
    """Returns train_step(state, batch, key[, lr]) -> (state, metrics):
    gradients averaged over microbatches (key folded by microbatch
    index), one SGD-momentum update. `key` is a `core.draws.Key`; the SL
    link draws from it."""
    _tiny_sgd(cfg, optimizer)
    n_micro = auto_microbatch(shape_cfg)
    _, opt_update = sgd_momentum(momentum)

    def train_step(state: TrainState, batch: dict, key, lr=lr):
        if wcfg is not None and wcfg.mode == "cl" \
                and not wcfg.perfect_channel:
            batch, _ = centralized.upload_batch(key.draws(), batch,
                                                cfg.vocab_size, wcfg)
        g_acc = m_acc = None
        for i in range(n_micro):
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            metrics, g = value_and_grad(state.trainable, mb, cfg, wcfg,
                                        key.fold_in(i))
            if g_acc is None:
                g_acc = tree_map(lambda b: torch.zeros_like(b) + b.float(),
                                 g)
                m_acc = {k: torch.zeros_like(v) + v
                         for k, v in metrics.items()}
            else:
                g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
                m_acc = {k: m_acc[k] + v for k, v in metrics.items()}
        grads = tree_map(lambda g: g / n_micro, g_acc)
        metrics = {k: v / n_micro for k, v in m_acc.items()}
        trainable, opt_state = opt_update(grads, state.opt_state,
                                          state.trainable, lr)
        return TrainState(trainable, opt_state, state.step + 1), metrics

    return train_step
