"""Communication energy (paper Eq. 11) — the part of
`repro/core/energy.py` the Radio bill needs. numpy only, so the numbers
are the JAX package's bit for bit."""
from __future__ import annotations

import numpy as np


def snr_linear(snr_db: float) -> float:
    return 10.0 ** (snr_db / 10.0)


def channel_capacity(bandwidth_hz: float, snr_db: float, fading: bool = True,
                     n_mc: int = 10_000, seed: int = 0) -> float:
    """E[C] in bits/s (Eq. 11), Monte-Carlo over Rayleigh |f|^2 ~ Exp(1)."""
    snr = snr_linear(snr_db)
    if not fading:
        return bandwidth_hz * np.log2(1.0 + snr)
    rng = np.random.default_rng(seed)
    f2 = rng.exponential(1.0, n_mc)
    return float(bandwidth_hz * np.mean(np.log2(1.0 + f2 * snr)))
