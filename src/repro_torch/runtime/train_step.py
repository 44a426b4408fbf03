"""Step builders: training (with gradient accumulation over microbatches)
and prefill — the port of `repro/runtime/train_step.py` for the paper's
tiny model and every scaled family (dense, MoE, VLM, SSM, hybrid,
audio). The
wireless mode is woven in here: SL routes the forward through the split +
channel link (core/split.py); CL with a noisy link corrupts the tiny
model's raw uplink tokens. FL wraps these in runtime/fl_runtime.py.

Gradients come from autograd: a step differentiates detached aliases of
the trainable tree's leaves (`torch.autograd.grad`) and applies the
plain-tensor optimizer update (optim/sgd.py, optim/adamw.py), in the
JAX step's order. A train step owns the state it is given: AdamW
updates it in place (see `make_train_step`).

The sharding helpers (`trainable_axes`, `train_state_axes`,
`train_state_sds`, `key_sds`) give a train state's logical axes and
its meta-tensor stand-in (shapes and dtypes, no allocation), as the
JAX module's do; `Lowered` resolves each leaf's spec on a mesh
(nn/sharding.py's `tree_shardings`). The scaled schemes' `lower_step`
and launch/dryrun.py read them. The step pins its gradient accumulator
to the parameters' axes (`constrain_tree`), which on the one-card mesh
is the identity.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import centralized
from repro_torch.core.draws import Key
from repro_torch.core.split import codec_specs, init_codec, split_forward
from repro_torch.models import api as M
from repro_torch.models import lstm_tiny
from repro_torch.nn import (axes_tree, constrain_tree, init_tree, shapes_tree,
                            tree_leaves, tree_map, tree_shardings,
                            tree_unflatten)
from repro_torch.nn.sharding import local_bytes, map_axes, use_mesh
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.sgd import SGDState

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


# data shards of the one card the live steps run on: with no shape
# override and no arch microbatch_size, a micro-step takes one sequence
# (at train_4k, 4,096 tokens: qwen1.5-0.5b's f32 logits alone are 2.5
# GB a sequence). The JAX package's live default is its production
# mesh's 16; the dry run passes its mesh's count
LIVE_DATA_SHARDS = 1


def auto_microbatch(cfg, shape_cfg,
                    n_data_shards: int = LIVE_DATA_SHARDS) -> int:
    """Number of grad-accumulation microbatches: the shape's override,
    then the arch's microbatch_size, then one sample per data shard
    (the JAX package's rule)."""
    if shape_cfg.microbatch:
        return shape_cfg.global_batch // shape_cfg.microbatch
    if cfg.microbatch_size and shape_cfg.global_batch > cfg.microbatch_size:
        return shape_cfg.global_batch // cfg.microbatch_size
    return max(1, shape_cfg.global_batch // n_data_shards)


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


def trainable_axes(cfg, wcfg=None) -> dict:
    """Logical axes of the trainable tree {"model", "codec"}."""
    return {"model": M.param_axes(cfg),
            "codec": (axes_tree(codec_specs(cfg, wcfg))
                      if (wcfg is not None and wcfg.mode == "sl") else {})}


def _accumulator(grads) -> list:
    """The first microbatch's gradient leaves as the step's float32
    accumulator, written in place from here on: autograd's own tensors
    where they are float32, dense and not shared with another leaf (a
    leaf used only through an expand, or two leaves handed one tensor,
    get a copy), a float32 copy of any other dtype. `+ 0.0` turns a -0.0
    entry into +0.0, as the JAX step's `zeros + g` accumulator does."""
    out, seen = [], set()
    for b in tree_leaves(grads):
        a = b.float()
        if a is b and (not a.is_contiguous() or a.data_ptr() in seen):
            a = a.clone(memory_format=torch.contiguous_format)
        seen.add(a.data_ptr())
        out.append(a.add_(0.0))
    return out


def make_train_step(cfg, shape_cfg, wcfg=None, optimizer: str = "adamw",
                    lr: float = 3e-4, momentum: float = 0.9,
                    n_data_shards: int = LIVE_DATA_SHARDS):
    """Returns train_step(state, batch, key[, lr]) -> (state, metrics):
    gradients summed over `auto_microbatch` microbatches in float32
    accumulators (microbatch i on key.fold_in(i)), divided by their
    count, then one optimizer update. `key` is a `core.draws.Key`; the
    SL link draws from it.

    The step takes ownership of `state`, as the JAX step's donated
    argument: AdamW updates the weights and its moments in place and
    returns the same tensors, so a caller that reads the old state after
    the step clones it first. The accumulator is the first microbatch's
    gradient, summed into and divided in place."""
    _check_family(cfg)
    window = window_for(cfg, shape_cfg)
    n_micro = auto_microbatch(cfg, shape_cfg, n_data_shards)
    _, opt_update = _optimizer(optimizer, momentum)
    tax = trainable_axes(cfg, wcfg)     # the accumulator's placement

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
                g_acc = tree_unflatten(g, _accumulator(g))
                m_acc = {k: torch.zeros_like(v) + v
                         for k, v in metrics.items()}
            else:
                for a, b in zip(tree_leaves(g_acc), tree_leaves(g)):
                    a.add_(b.float())
                m_acc = {k: m_acc[k] + v for k, v in metrics.items()}
            g_acc = constrain_tree(g_acc, tax)
            del g
        for a in tree_leaves(g_acc):
            a.div_(n_micro)
        metrics = {k: v / n_micro for k, v in m_acc.items()}
        trainable, opt_state = opt_update(g_acc, state.opt_state,
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


# ------------------------------------------------- state specs / shardings
def key_sds() -> Key:
    """The stand-in of a built step's key argument: a `Key` holds no
    tensor, so any one serves."""
    return Key(0)


def train_state_axes(cfg, wcfg=None, optimizer: str = "adamw",
                     n_users: int = 0) -> TrainState:
    """Logical-axes tree of a whole TrainState (trainable + optimizer
    moments + step). With n_users > 0 every leaf gains a leading "users"
    axis: the FL user-stacked layout ("users" resolves to `pod`)."""
    tax = trainable_axes(cfg, wcfg)
    if n_users:
        tax = map_axes(lambda ax: ("users",) + ax, tax)
    _optimizer(optimizer)                       # validates the name
    opt_ax = (AdamWState(tax, tax, ()) if optimizer == "adamw"
              else SGDState(tax, ()))
    return TrainState(tax, opt_ax, ())


def train_state_sds(cfg, wcfg=None, optimizer: str = "adamw",
                    n_users: int = 0) -> TrainState:
    """A TrainState of meta tensors in `init_train_state`'s layout (the
    step counters plain ints), user-stacked when n_users > 0."""
    _check_family(cfg)
    trainable = {"model": shapes_tree(M.train_param_specs(cfg)),
                 "codec": (shapes_tree(codec_specs(cfg, wcfg))
                           if (wcfg is not None and wcfg.mode == "sl")
                           else {})}
    if n_users:
        trainable = tree_map(lambda t: t.new_empty((n_users,) + t.shape),
                             trainable)
    opt_init, _ = _optimizer(optimizer)
    return TrainState(trainable, opt_init(trainable), 0)


def metrics_sds(cfg) -> dict:
    """The metrics a built step returns, as meta f32 scalars."""
    keys = ("loss", "accuracy", "aux_loss") if cfg.family == "tiny" \
        else ("loss", "aux_loss")
    return {k: torch.empty((), dtype=torch.float32, device="meta")
            for k in keys}


@dataclasses.dataclass
class Lowered:
    """A step readied for a mesh without running it: the port's
    counterpart of JAX's `Lowered` (what `lower_step` and
    launch/dryrun.py return). `args` are the step's tensor arguments as
    meta trees with their logical axes, `specs` each leaf's resolved
    spec on `mesh`; `outputs` / `out_axes` likewise (the donated `args`
    come back as outputs). Nothing is compiled: the step is the eager
    program the card runs, and `flops` counts its matmuls on meta
    tensors (`FlopCounterMode`) when first asked."""
    step: Callable
    args: tuple
    arg_axes: tuple
    outputs: tuple
    out_axes: tuple
    mesh: Any
    flops: Callable[[], float]
    donate: tuple = (0,)

    def __post_init__(self):
        self.specs = tuple(tree_shardings(a, ax, self.mesh)
                           for a, ax in zip(self.args, self.arg_axes))
        self._flops = None

    def cost_analysis(self) -> dict:
        """{"flops": matmul FLOPs of one call of the whole program}: the
        count launch/hlo_analysis.py takes from JAX's compiled HLO
        (`dot_flops`), not XLA's `cost_analysis`, which counts a scan's
        body once."""
        if self._flops is None:
            with use_mesh(None):          # the whole program, one card
                self._flops = float(self.flops())
        return {"flops": self._flops}

    def memory_analysis(self):
        """Bytes per device from the resolved specs: every argument and
        output leaf's share on `mesh` (a replicated leaf whole), the
        donated arguments as the aliased bytes. Temporaries and code size
        are None: nothing compiles the program."""
        def size(trees, axes):
            return sum(local_bytes(t, ax, self.mesh)
                       for t, ax in zip(trees, axes))
        return types.SimpleNamespace(
            argument_size_in_bytes=size(self.args, self.arg_axes),
            output_size_in_bytes=size(self.outputs, self.out_axes),
            alias_size_in_bytes=size([self.args[i] for i in self.donate],
                                     [self.arg_axes[i] for i in self.donate]),
            temp_size_in_bytes=None, generated_code_size_in_bytes=None)
