"""Gradient clipping (paper: global-norm clip at tau=0.5, Alg. 2) — the
port of `repro/optim/clip.py`."""
from __future__ import annotations

import torch

from repro_torch.nn.core import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


def clip_array_by_norm(x: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Per-tensor norm clip, used on the smashed-data gradient in SL."""
    norm = torch.sqrt(torch.sum(torch.square(x.float())))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    # a bf16 x is scaled in float32 and rounded once, as jnp promotes it
    return (x.float() * scale).to(x.dtype)
