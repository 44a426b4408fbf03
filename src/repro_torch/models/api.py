"""Unified model API: dispatch by family — the port of
`repro/models/api.py`. The `dense` family and the paper's `tiny`
classifier (a streaming decoder with no fused prefill, so serving
prefills it by the exact scan) are ported; the others raise and are
listed in ROADMAP.md."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.models import lstm_tiny, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    specs: Callable
    forward: Callable
    cache_shapes: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    prefill_step: Optional[Callable] = None


_FAMILIES = {
    "dense": ModelApi(transformer.model_specs, transformer.forward,
                      transformer.init_cache_shapes, transformer.init_cache,
                      transformer.decode_step, transformer.prefill_step),
    "tiny": ModelApi(lstm_tiny.model_specs, lstm_tiny.forward,
                     lstm_tiny.cache_shapes, lstm_tiny.init_cache,
                     lstm_tiny.decode_step),
}


def get_model(cfg) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port has "
            f"{sorted(_FAMILIES)} (see ROADMAP.md, P15)")
    return _FAMILIES[cfg.family]


def param_specs(cfg):
    return get_model(cfg).specs(cfg)
