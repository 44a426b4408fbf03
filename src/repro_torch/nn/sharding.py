"""Logical-axis -> mesh-axis resolution — the port of
`repro/nn/sharding.py` (MaxText-style logical_axis_rules).

A *rule set* is an ordered list of (logical_name, mesh_axes) pairs where
mesh_axes is a mesh-axis name, a tuple of them, or None. Resolution walks
a tensor's logical axes; for each, the first rule whose mesh axes (a) all
exist in the mesh, (b) are not yet taken by another dim of this tensor,
and (c) whose combined size divides the dim, wins. Non-divisible or
exhausted axes degrade to replication.

The rules and the resolver are the JAX package's, leaf for leaf; a
resolved spec is a tuple of mesh-axis entries (a name, a tuple of names,
or None per dim, trailing Nones stripped), what `PartitionSpec` holds.
The port runs on one card, so every mesh it runs tensors under is all
ones (launch/mesh.py) and every spec it resolves there replicates:
`constrain` is then the identity. Eager PyTorch has no SPMD partitioner,
so under a mesh with more than one device along an axis a constraint
would use, `constrain` raises instead of pretending to shard; the
16 x 16 and 2 x 16 x 16 meshes exist only as device-less descriptors
that the dry run resolves specs against (launch/dryrun.py).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Optional, Sequence

# Default rules. Order matters: earlier rules are preferred.
DEFAULT_RULES: list[tuple[str, Any]] = [
    ("users", "pod"),           # FL user replicas live on the pod axis
    ("clients", ("pod", "data")),   # fleet-engine per-client draws
    ("batch", ("pod", "data")),
    ("vocab", "model"),
    ("embed", "data"),          # fsdp sharding for the param embed dim
    ("heads", "model"),
    ("kv_heads", "model"),
    ("qkv", "model"),
    ("mlp", "model"),
    ("experts", "model"),
    ("expert_mlp", None),
    ("kv_seq", ("model",)),     # decode cache sequence sharding
    ("long_seq", ("data", "model")),
    ("act_embed", None),
    ("seq", None),
    ("layers", None),
    ("conv", None),
    ("state", None),
]


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: list[tuple[str, Any]] = list(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Sequence] = None):
    """Make `mesh` (launch/mesh.py's `Mesh`, or None) and `rules` the
    current ones in this thread while the block runs."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = list(rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def current_mesh():
    return _CTX.mesh


def _rule_for(name: str, rules) -> Any:
    for k, v in rules:
        if k == name:
            return v
    return None


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh, rules=None) -> tuple:
    """The mesh-axis entry of each dim of a tensor of `shape` whose dims
    are named `axes`; reads only `mesh.shape` (an ordered {axis: size})."""
    rules = rules if rules is not None else _CTX.rules
    taken: set[str] = set()
    parts = []
    for dim, name in zip(shape, axes):
        if name is None:
            parts.append(None)
            continue
        want = _rule_for(name, rules)
        if want is None:
            parts.append(None)
            continue
        cand = (want,) if isinstance(want, str) else tuple(want)
        # keep the longest usable prefix of the candidate axes
        chosen = []
        size = 1
        for ax in cand:
            if ax not in mesh.shape or ax in taken:
                continue
            if dim % (size * mesh.shape[ax]) != 0:
                continue
            chosen.append(ax)
            size *= mesh.shape[ax]
        if chosen:
            taken.update(chosen)
            parts.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
        else:
            parts.append(None)
    # strip trailing Nones for cleanliness
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_ways(spec: tuple, mesh) -> int:
    """How many ways a resolved spec splits its tensor over `mesh`: the
    product of the sizes of the mesh axes it uses."""
    ways = 1
    for part in spec:
        for ax in ((part,) if isinstance(part, str) else part or ()):
            ways *= mesh.shape[ax]
    return ways


def named_sharding(shape, axes, mesh=None, rules=None) -> Optional[tuple]:
    """The resolved spec of one tensor on `mesh` (default: the current
    mesh); None without a mesh."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return None
    return resolve_spec(shape, axes, mesh, rules)


def constrain(x, *axes: Optional[str]):
    """A sharding constraint by logical axes: `x` itself without a mesh
    or where every axis the constraint would use has size 1. Under a
    mesh that would split `x` it raises: one card has nothing to place
    a shard on."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    spec = resolve_spec(x.shape, axes, mesh)
    if spec_ways(spec, mesh) > 1:
        raise RuntimeError(
            f"constrain{tuple(axes)} would split a {tuple(x.shape)} tensor "
            f"as {spec} over mesh {dict(mesh.shape)}: the port runs on one "
            f"card, and sharding across cards is not part of it (ROADMAP.md,"
            f" queue 1 item 7)")
    return x


def refuse_model_split(what: str) -> None:
    """Raise where the current mesh's `model` axis spans more than one
    device: there the JAX package splits `what` over it, and one card
    has nothing to place a shard on."""
    mesh = _CTX.mesh
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise RuntimeError(
            f"{what} over a model axis of {mesh.shape['model']} devices: "
            f"the port runs on one card, and sharding across cards is not "
            f"part of it (ROADMAP.md, queue 1 item 7)")


def is_axes_leaf(a) -> bool:
    """A logical-axes tree leaf: a (possibly empty) tuple of axis names
    (a NamedTuple is a node)."""
    return isinstance(a, tuple) and not hasattr(a, "_fields") and all(
        isinstance(e, (str, type(None))) for e in a)


def map_axes(fn, axes_tree, *trees):
    """`fn(axes, *leaves)` over an axes tree and trees shaped like it
    (dicts in sorted-key order, lists, tuples and NamedTuples in order),
    traversed by the axes tree, as `jax.tree.map` with an axes-leaf
    predicate does."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in sorted(axes_tree)}
    if isinstance(axes_tree, (list, tuple)):
        out = [map_axes(fn, a, *(t[i] for t in trees))
               for i, a in enumerate(axes_tree)]
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*out)
        return type(axes_tree)(out)
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def constrain_tree(tree, axes_tree):
    """`constrain` over a tree by its logical-axes tree; `tree` itself
    without a mesh."""
    if _CTX.mesh is None:
        return tree
    return map_axes(lambda axes, x: constrain(x, *axes), axes_tree, tree)


def tree_shardings(shapes_tree, axes_tree, mesh=None, rules=None):
    """(tree of tensors / meta tensors, axes tree) -> tree of resolved
    specs, traversed by the axes tree (a plain-number leaf, a step
    counter, is a scalar)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    return map_axes(lambda axes, t: named_sharding(
        tuple(getattr(t, "shape", ())), axes, mesh, rules),
        axes_tree, shapes_tree)


def local_bytes(shapes_tree, axes_tree, mesh) -> int:
    """Bytes one device of `mesh` holds of a tree of tensors (or meta
    tensors) placed by its logical-axes tree; a non-tensor leaf (a step
    counter) holds none."""
    total = 0

    def add(axes, t):
        nonlocal total
        if hasattr(t, "element_size"):
            spec = resolve_spec(tuple(t.shape), axes, mesh)
            total += (math.prod(t.shape) * t.element_size()
                      // spec_ways(spec, mesh))
    map_axes(add, axes_tree, shapes_tree)
    return total
