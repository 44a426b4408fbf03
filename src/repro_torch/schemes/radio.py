"""`Radio` — the one owner of the channel knobs, and `Delivery`, what a
send returns: the port of `repro/schemes/radio.py`, token path only
(`send_tree` / `send_stacked` / `bill_counts` come with the wire slice).

Bills are host-side float64 arithmetic in the JAX package's order, so
the same drawn fades give the same `Delivery` bit for bit. Random
numbers come from the caller's `Draws` (core/draws.py) in place of a
JAX key.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import channel as CH
from repro_torch.core import energy as EN
from repro_torch.core import wire as W
from repro_torch.core.centralized import token_bits


@functools.lru_cache(maxsize=64)
def _expected_capacity(bandwidth_hz: float, snr_db: float,
                       fading: bool) -> float:
    """Cached E_f[C] (Monte-Carlo over Rayleigh |f|^2, energy.py)."""
    return EN.channel_capacity(bandwidth_hz, snr_db, fading)


@dataclasses.dataclass(frozen=True)
class Delivery:
    """One radio transmission, received side + accounting."""
    payload: Any
    bits: float
    energy_j: float
    n_tx: float
    user_bits: Optional[tuple] = None
    user_n_tx: Optional[tuple] = None
    erased_bits: float = 0.0
    outage_s: float = 0.0
    user_erased: Optional[tuple] = None
    user_erased_bits: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class Radio:
    """Channel knobs, held once per run (paper Table I + beyond-paper
    ARQ and fault model); field for field the JAX package's Radio."""
    quant_bits: int = 8
    snr_db: float = 20.0
    fading: bool = True
    perfect: bool = False
    arq_attempts: int = 1
    arq_min_f2: float = 0.25
    bandwidth_hz: float = 100e3
    tx_power_w: float = 1e-3
    use_kernel: bool = False
    wire_dtype: str = "float32"
    arq_max_tx: int = 0
    ge_p_gb: float = 0.0
    ge_p_bg: float = 0.5
    arq_backoff_s: float = 0.0
    rounding: str = "nearest"

    @classmethod
    def from_wcfg(cls, wcfg, quant_bits: Optional[int] = None,
                  use_kernel: bool = False, **overrides) -> "Radio":
        """Build from a WirelessConfig; None means an ideal (perfect,
        non-fading) link. `overrides` replace individual fields."""
        if wcfg is None:
            base = cls(perfect=True, fading=False)
        else:
            base = cls(quant_bits=int(quant_bits or wcfg.quant_bits),
                       snr_db=float(wcfg.snr_db), fading=bool(wcfg.fading),
                       perfect=bool(wcfg.perfect_channel),
                       arq_attempts=int(wcfg.arq_attempts),
                       arq_min_f2=float(wcfg.arq_min_f2),
                       bandwidth_hz=float(wcfg.bandwidth_hz),
                       tx_power_w=float(wcfg.tx_power_w),
                       use_kernel=bool(use_kernel or wcfg.use_kernel),
                       wire_dtype=str(wcfg.wire_dtype),
                       arq_max_tx=int(wcfg.arq_max_tx),
                       ge_p_gb=float(wcfg.ge_p_gb),
                       ge_p_bg=float(wcfg.ge_p_bg),
                       arq_backoff_s=float(wcfg.arq_backoff_s),
                       rounding=str(wcfg.rounding))
        return dataclasses.replace(base, **overrides) if overrides else base

    def rate_bps(self) -> float:
        """Expected link rate E_f[C] in bits/s (cached per link budget)."""
        return _expected_capacity(self.bandwidth_hz, self.snr_db,
                                  self.fading)

    def energy_j(self, bits: float) -> float:
        """Comm energy of `bits` on this link: bits * P / E[C]."""
        return float(bits) * self.tx_power_w / self.rate_bps()

    # the JAX package's disjoint key fold for the per-row token ARQ draw
    # (its draws are the "arq"/"ge_*" names of the same `Draws` here)
    _TOKEN_ARQ_FOLD = 4242

    def send_tokens(self, draws, tokens: torch.Tensor, vocab_size: int,
                    labels=None) -> Delivery:
        """CL / serving uplink: raw token ids as fixed-width codewords,
        one packet (fade) per row; labels ride a 1-bit control channel.
        Bits — and one transmission per row — are charged perfect or
        not. Under bounded ARQ (`arq_max_tx > 0`) each row draws its own
        retransmission count; an exhausted row is ERASED: delivered as
        zeros, its whole attempted slice billed into `erased_bits` and
        flagged in `user_erased`."""
        n_bits = token_bits(vocab_size)
        if self.perfect:
            payload = tokens
        else:
            payload = CH.transmit_tokens(draws, tokens, vocab_size,
                                         snr_db=self.snr_db,
                                         fading=self.fading)
        base_bits = W.payload_bits(tokens, n_bits)
        if labels is not None:
            base_bits += W.payload_bits(labels, 1)
        n_rows = tokens.shape[0] if tokens.ndim > 1 else 1
        if self.arq_max_tx <= 0 or W.fault_free(
                self.fading, self.perfect, self.arq_attempts,
                self.arq_min_f2, self.arq_max_tx, self.ge_p_gb):
            return Delivery(payload, base_bits, self.energy_j(base_bits),
                            float(n_rows))
        n_tx, erased = W.drawn_stacked_tx(
            draws, n_rows, 1, self.fading, self.perfect, self.arq_attempts,
            self.arq_min_f2, self.arq_max_tx, self.ge_p_gb, self.ge_p_bg,
            with_erased=True)
        n_tx = np.asarray(n_tx, np.float64)[:, 0]
        erased = np.asarray(erased, bool)[:, 0]
        row_bits = base_bits / n_rows
        bits = float(row_bits * n_tx.sum())
        erased_bits = float(row_bits * (n_tx * erased).sum())
        if erased.any():
            er = torch.as_tensor(erased)
            payload = torch.where(er[:, None] if tokens.ndim > 1 else er[0],
                                  0, payload)
        return Delivery(
            payload, bits, self.energy_j(bits), float(n_tx.sum()),
            tuple(float(row_bits * t) for t in n_tx),
            tuple(float(t) for t in n_tx), erased_bits,
            float(W.backoff_s(n_tx, self.arq_backoff_s)),
            tuple(bool(e) for e in erased),
            tuple(float(row_bits * t * e) for t, e in zip(n_tx, erased)))
