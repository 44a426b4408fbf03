"""Tree checkpoints to .npz — the port of `repro/checkpoint/ckpt.py`, in
the JAX package's file format: one .npz per snapshot, keys the
'/'-joined paths of the tree's leaves (dict keys, list indices, the
field names of NamedTuples and dataclasses), written to a temporary
file and then `os.replace`d, so a crash mid-save leaves the previous
snapshot intact.

* `save_checkpoint` / `restore_checkpoint` / `latest_step`: a bare tree.
* `save_experiment` / `latest_experiment_cycle` / `load_experiment`: a
  CRASH-CONSISTENT experiment snapshot, the scheme's train state (keys
  `train/<path>`) plus a JSON `__meta__` record (cycle index, data-rng
  state, the reports, accuracies and bills so far) in one file, so a run
  killed at cycle k and resumed reproduces the rest of the trajectory
  and every bit of its billing (schemes/run.py `Experiment`).

Tensors leave the device as numpy arrays and come back to the
template's device and dtype with the same bits; Python-scalar leaves
(step counters) are stored as 0-d arrays and come back as the
template's type.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _children(node):
    """(name, child) pairs of a tree node, or None for a leaf. None and
    empty containers have no leaves."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if node is None:
        return []
    return None


def _rebuild(node, kids: list):
    if isinstance(node, dict):
        return {k: kid for k, kid in zip(sorted(node), kids)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*kids)
    if isinstance(node, (list, tuple)):
        return type(node)(kids)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: k for f, k in zip(dataclasses.fields(node), kids)})
    return node


def _map_with_path(fn, tree, prefix: str = ""):
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [
        _map_with_path(fn, c, f"{prefix}/{name}" if prefix else name)
        for name, c in kids])


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict:
    out = {}

    def put(path, leaf):
        out[path] = _host(leaf)
        return leaf
    _map_with_path(put, tree)
    return out


def _restore_leaf(key: str, arr: np.ndarray, leaf):
    """`arr` as the template `leaf`'s kind: a Python scalar of its type,
    a tensor on its device and dtype, or a numpy array."""
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr.item())
    if tuple(arr.shape) != tuple(np.shape(leaf)):
        raise ValueError(f"{key}: stored shape {arr.shape}, template "
                         f"{tuple(np.shape(leaf))}")
    if torch.is_tensor(leaf):
        return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                  dtype=leaf.dtype)
    return np.array(arr, dtype=np.asarray(leaf).dtype)


def _atomic_savez(path: str, payload: dict) -> str:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)     # a crash mid-save never tears a snapshot
    return path


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    return _atomic_savez(os.path.join(directory, f"ckpt_{step:08d}.npz"),
                         _flatten_with_paths(tree))


def _latest(directory: str, pattern: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    found = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(pattern, f))]
    return max(found) if found else None


def latest_step(directory: str) -> Optional[int]:
    return _latest(directory, r"ckpt_(\d+)\.npz$")


def restore_checkpoint(directory: str, step: int, template: Any) -> Any:
    """The tree saved at `step`, shaped like `template` (its tensors on
    their template's devices)."""
    data = np.load(os.path.join(directory, f"ckpt_{step:08d}.npz"))
    return _map_with_path(lambda k, leaf: _restore_leaf(k, data[k], leaf),
                          template)


# ------------------------------------------------- experiment snapshots
def _json_default(o):
    """numpy scalars and arrays that ride report fields -> JSON."""
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o)!r}")


def save_experiment(directory: str, cycle: int, train: Any,
                    meta: dict) -> str:
    """Atomically snapshot one experiment: the train state (keys
    `train/<path>`) and `meta` as an embedded JSON record, in
    `exp_<cycle>.npz` (callers pass the NEXT cycle to run, so
    `latest_experiment_cycle` reads as the resume point)."""
    os.makedirs(directory, exist_ok=True)
    payload = {"train/" + k: v
               for k, v in _flatten_with_paths(train).items()}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta, default=_json_default).encode("utf-8"), np.uint8)
    return _atomic_savez(os.path.join(directory, f"exp_{cycle:08d}.npz"),
                         payload)


def latest_experiment_cycle(directory: str) -> Optional[int]:
    return _latest(directory, r"exp_(\d+)\.npz$")


def load_experiment(path: str, template_train: Any) -> Tuple[Any, dict]:
    """-> (train state, meta). `path` is one `exp_*.npz` file or a
    checkpoint directory (its latest snapshot). `template_train` fixes
    the structure and each leaf's kind; a stored shape that differs from
    the template's raises."""
    if os.path.isdir(path):
        c = latest_experiment_cycle(path)
        if c is None:
            raise FileNotFoundError(
                f"no exp_*.npz experiment snapshot under {path!r}")
        path = os.path.join(path, f"exp_{c:08d}.npz")
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
    train = _map_with_path(
        lambda k, leaf: _restore_leaf(k, data["train/" + k], leaf),
        template_train)
    return train, meta
