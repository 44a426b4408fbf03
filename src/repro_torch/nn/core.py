"""Parameter declaration and initialisation — the port of `repro/nn/core.py`.

Models declare a tree of :class:`Spec` leaves (shape + logical axes +
initializer), exactly as in the JAX package. ``init_params`` turns the
tree into a :class:`ParamDict`, an ``nn.Module`` whose dict nodes are
submodules, list nodes ``nn.ModuleList``s and Spec leaves registered
``nn.Parameter``s, so ``.to(device)`` moves the whole model. Layer code
reads it like the JAX pytree (``p["wq"]["w"]``, ``"b" in p``).

Training takes a plain tree instead (``init_tree``): nested dicts of
tensors, flattened in sorted-key order as JAX flattens a dict pytree
(``tree_leaves``/``tree_map``/``tree_unflatten``), so the packed wire
lays leaves out, and draws their fades, in the JAX package's order.
Its leaves are ordinary tensors; a train step differentiates detached
copies (runtime/train_step.py), so the tree is trainable without being
a module.

Initialisation draws from the caller's seeded ``torch.Generator``; it
is not JAX's init bitwise. ``params_from_jax`` loads the JAX package's
parameters (as numpy arrays) instead, which the parity tests use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default and is
    never silently replaced by the CPU: asking for it without a GPU
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return dev


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter leaf."""

    shape: tuple
    axes: tuple  # logical axis name (str) or None per dim
    init: str = "fan_in"  # fan_in | normal | zeros | ones | uniform | embed
    dtype: Any = torch.float32
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def stack_specs(specs, n: int, axis_name: str = "layers"):
    """Prepend a stacked dim of `n` to every Spec of a tree (the JAX
    package's `stack_specs`: the layout its `lax.scan` over layers
    reads)."""
    if isinstance(specs, dict):
        return {k: stack_specs(v, n, axis_name) for k, v in specs.items()}
    return Spec((n,) + specs.shape, (axis_name,) + specs.axes, specs.init,
                specs.dtype, specs.scale)


def _init_leaf(spec: Spec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    kw = {"dtype": spec.dtype, "device": device}
    if spec.init == "zeros":
        return torch.zeros(spec.shape, **kw)
    if spec.init == "ones":
        return torch.ones(spec.shape, **kw)
    if spec.init in ("normal", "embed"):
        return spec.scale * torch.randn(spec.shape, generator=generator, **kw)
    if spec.init == "uniform":
        lim = spec.scale
        return (torch.rand(spec.shape, generator=generator, **kw)
                * (2 * lim) - lim)
    if spec.init == "eye":
        # (truncated) identity — the semantic codec's warm start
        return spec.scale * torch.eye(*spec.shape, **kw)
    if spec.init == "lstm_forget1":
        # Keras unit_forget_bias: zeros except the forget-gate quarter
        # (gate order i, f, g, o), which is 1.0
        b = torch.zeros(spec.shape, **kw)
        h = spec.shape[-1] // 4
        b[..., h:2 * h] = 1.0
        return b
    if spec.init == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[0], 1)
        if len(spec.shape) >= 3:
            fan_in = spec.shape[-2]
        std = spec.scale / math.sqrt(fan_in)
        return std * torch.randn(spec.shape, generator=generator, **kw)
    raise ValueError(f"unknown init {spec.init}")


class ParamDict(nn.Module):
    """A parameter tree as a module: dict-style access over submodules
    and parameters (inference-only, so ``requires_grad=False``)."""

    def __init__(self, tree: dict, make_leaf):
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, ParamDict(v, make_leaf))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(
                    ParamDict(x, make_leaf) for x in v))
            else:
                self.register_parameter(
                    k, nn.Parameter(make_leaf(v), requires_grad=False))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k) -> bool:
        return k in self._parameters or k in self._modules


def init_params(specs: dict, generator: torch.Generator,
                device="cuda") -> ParamDict:
    """Materialise a Spec tree on `device`, drawing every random leaf
    from `generator` (which must live on that device) in sorted-key
    order."""
    dev = resolve_device(device)
    return ParamDict(specs, lambda s: _init_leaf(s, generator, dev))


def params_from_jax(np_tree: dict, cfg=None, device="cuda"):
    """The JAX package's params, given as numpy arrays. Transformer
    params (stacked ``[L, ...]`` layer leaves, ``embed.table``,
    ``ln_f``; a MoE block's ``moe.router.w``, ``moe.wi`` / ``wg`` /
    ``wo`` ``[L, E, ...]`` and ``moe.shared`` alike) become the port's
    serving `ParamDict` with the stacked layers as a list of per-layer
    subtrees; the tiny, ssm, hybrid and audio families' (which keep
    JAX's stacked leaves: xLSTM's and Mamba2's super-blocks, the hybrid's
    tail and shared block, the encoder's and decoder's layers), and with
    `cfg` None any plain tree (the privacy adversary's MLP, an
    `SLSession`'s model and codec, a transformer's training tree with
    its layers kept stacked), become a trainable tree (``init_tree``'s
    layout)."""
    dev = resolve_device(device)
    if cfg is None or cfg.family in ("tiny", "ssm", "hybrid", "audio"):
        return tree_map(lambda a: torch.from_numpy(
            np.array(a, dtype=np.float32, copy=True)).to(dev), np_tree)

    def unstack(t, l):
        return {k: unstack(v, l) if isinstance(v, dict) else v[l]
                for k, v in t.items()}

    tree = dict(np_tree)
    tree["layers"] = [unstack(np_tree["layers"], l)
                      for l in range(cfg.n_layers)]
    return ParamDict(tree, lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(dev))


# --------------------------------------------------------- plain trees
def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (JAX's dict-pytree
    order); an empty dict has none."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` (tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def tree_map(fn, tree, *rest):
    """`fn` over corresponding leaves of trees of the same structure."""
    leaves = [fn(*xs) for xs in zip(tree_leaves(tree),
                                    *map(tree_leaves, rest))]
    return tree_unflatten(tree, leaves)


def tree_at(tree, i):
    """The [i] slice of every leaf of a stacked tree (views): one layer
    or super-block of the JAX package's stacked leaves."""
    return tree_map(lambda a: a[i], tree)


def init_tree(specs: dict, generator: torch.Generator,
              device="cuda") -> dict:
    """Materialise a Spec tree as a trainable plain tree on `device`,
    drawing every random leaf from `generator` in sorted-key order on
    the generator's own device (a CPU generator gives the same weights
    whatever `device` is)."""
    dev = resolve_device(device)
    return tree_map(lambda s: _init_leaf(s, generator,
                                         generator.device).to(dev), specs)


def count_params(params) -> int:
    """Parameter count of a `ParamDict`, a plain tree or a Spec tree."""
    if isinstance(params, nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    return int(sum(math.prod(x.shape) for x in tree_leaves(params)))


# ------------------------------------------------- spec trees
def _map_specs(fn, specs):
    """`fn` over the Spec leaves of a tree of dicts and lists."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v) for v in specs)
    return fn(specs)


def axes_tree(specs):
    """The logical-axes tree of a Spec tree (what the sharding resolver
    reads)."""
    return _map_specs(lambda s: s.axes, specs)


def shapes_tree(specs):
    """A Spec tree as meta tensors of the same shapes and dtypes: the
    JAX package's `ShapeDtypeStruct` stand-ins, which allocate
    nothing."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device="meta"), specs)

