"""Semantic compression codec at the SL split point (paper Sec. III-A2:
"A compression encoder factoring by four is adopted") — the port of
`repro/core/semantic.py`. The encoder lives user-side (before the
radio), the decoder server-side. Identity warm start: enc/dec start as
the (truncated) identity pair, so at step 0 the codec passes the first
d/factor channels through unchanged."""
from __future__ import annotations

import torch

from repro_torch.models.layers import linear
from repro_torch.nn import Spec


def codec_specs(d: int, factor: int) -> dict:
    c = max(1, d // factor)
    return {
        "enc": {"w": Spec((d, c), ("embed", None), init="eye"),
                "b": Spec((c,), (None,), init="zeros")},
        "dec": {"w": Spec((c, d), (None, "embed"), init="eye"),
                "b": Spec((d,), (None,), init="zeros")},
    }


def encode(codec: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(codec["enc"], x)


def decode(codec: dict, z: torch.Tensor) -> torch.Tensor:
    return linear(codec["dec"], z)
