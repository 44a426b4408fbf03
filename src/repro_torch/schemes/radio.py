"""`Radio` — the one owner of the channel knobs, and `Delivery`, what a
send returns: the port of `repro/schemes/radio.py`.

Bills are host-side float64 arithmetic in the JAX package's order, so
the same drawn fades give the same `Delivery` bit for bit. Random
numbers come from the caller's `Draws` (core/draws.py) in place of a
JAX key. `send_tree`/`send_stacked` go through the packed wire, which
launches the quant_channel kernel on the card (core/wire.py).
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
from repro_torch.nn.core import tree_leaves


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

    # ----------------------------------------------------------- account
    def expected_tx(self) -> float:
        """Analytic expected transmissions per packet under outage-ARQ
        (bounded ARQ: the cap replaces `arq_attempts`; Gilbert-Elliott
        mixes the two link states)."""
        a = self.arq_max_tx if self.arq_max_tx > 0 else self.arq_attempts
        base = W.expected_arq_tx(a, self.arq_min_f2, self.fading,
                                 self.perfect)
        if self.ge_p_gb > 0.0 and not self.perfect:
            pi_bad = self.ge_p_gb / (self.ge_p_gb + self.ge_p_bg)
            return pi_bad * float(a) + (1.0 - pi_bad) * base
        return base

    def wire_width(self) -> int:
        """Billed on-air bits per codeword (wire.wire_width)."""
        return W.wire_width(self.wire_dtype, self.quant_bits)

    def payload_bits(self, tree) -> float:
        """Analytic one-transmission payload of `tree` at this radio's
        quantization, billed at the wire container width."""
        return W.payload_bits(tree, self.quant_bits,
                              wire_dtype=self.wire_dtype)

    def rate_bps(self) -> float:
        """Expected link rate E_f[C] in bits/s (cached per link budget)."""
        return _expected_capacity(self.bandwidth_hz, self.snr_db,
                                  self.fading)

    def energy_j(self, bits: float) -> float:
        """Comm energy of `bits` on this link: bits * P / E[C]."""
        return float(bits) * self.tx_power_w / self.rate_bps()

    def bill_counts(self, n_tx, sizes, erased=None) -> Delivery:
        """`Delivery` reduction without a payload: bill a (stacked) send
        from its drawn per-(user, packet) transmission counts and
        erasure mask, exactly as `send_stacked` bills its own."""
        return self._deliver(None, n_tx, sizes, erased)

    def _impl(self) -> str:
        return "kernel" if (self.use_kernel and not self.perfect) \
            else "packed"

    def _deliver(self, payload, n_tx, sizes, erased=None) -> Delivery:
        n_tx = np.asarray(n_tx, np.float64)
        sizes = np.asarray(sizes, np.float64)
        width = float(self.wire_width())
        bits = width * float((sizes * n_tx).sum())
        user_bits = user_n_tx = user_erased = None
        if n_tx.ndim == 2:      # stacked send: keep the per-user split
            user_bits = tuple(float(b) for b in
                              width * (sizes * n_tx).sum(axis=1))
            user_n_tx = tuple(float(t) for t in n_tx.sum(axis=1))
        erased_bits = 0.0
        user_erased_bits = None
        if erased is not None and self.arq_max_tx > 0:
            e = np.asarray(erased, bool)
            erased_bits = width * float((sizes * n_tx * e).sum())
            if n_tx.ndim == 2:
                user_erased = tuple(bool(x) for x in e.any(axis=1))
                user_erased_bits = tuple(
                    float(b) for b in
                    width * (sizes * n_tx * e).sum(axis=1))
        outage_s = W.backoff_s(n_tx, self.arq_backoff_s)
        return Delivery(payload, bits, self.energy_j(bits),
                        float(n_tx.sum()), user_bits, user_n_tx,
                        erased_bits, float(outage_s), user_erased,
                        user_erased_bits)

    # -------------------------------------------------------------- send
    def _link(self) -> dict:
        return dict(fading=self.fading, perfect=self.perfect,
                    arq_attempts=self.arq_attempts,
                    arq_min_f2=self.arq_min_f2, impl=self._impl(),
                    return_diag=True, wire_dtype=self.wire_dtype,
                    arq_max_tx=self.arq_max_tx, ge_p_gb=self.ge_p_gb,
                    ge_p_bg=self.ge_p_bg, rounding=self.rounding)

    def send_tree(self, draws, tree) -> Delivery:
        """Transmit every leaf of a tree (one packet per tensor) through
        the packed wire. SL legs, single-user weight uploads."""
        payload, diag = W.transmit_tree(draws, tree, self.quant_bits,
                                        self.snr_db, **self._link())
        sizes = [int(l.numel()) for l in tree_leaves(tree)]
        return self._deliver(payload, diag["n_tx"].numpy(), sizes,
                             diag["erased"].numpy())

    def send_stacked(self, draws, tree) -> Delivery:
        """Transmit a tree whose leaves carry a leading user axis
        [N, ...] — FL's whole N-user upload in one pass, one packet
        (fade + scale) per (user, tensor). The payload keeps the user
        axis; aggregation is the scheme's job."""
        leaves = tree_leaves(tree)
        payload, diag = W.transmit_stacked(draws, tree, self.quant_bits,
                                           self.snr_db, **self._link())
        sizes = [int(l.numel()) // int(l.shape[0]) for l in leaves]
        return self._deliver(payload, diag["n_tx"].numpy(), sizes,
                             diag["erased"].numpy())

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
            er = torch.as_tensor(erased, device=payload.device)
            payload = torch.where(er[:, None] if tokens.ndim > 1 else er[0],
                                  0, payload)
        return Delivery(
            payload, bits, self.energy_j(bits), float(n_tx.sum()),
            tuple(float(row_bits * t) for t in n_tx),
            tuple(float(t) for t in n_tx), erased_bits,
            float(W.backoff_s(n_tx, self.arq_backoff_s)),
            tuple(bool(e) for e in erased),
            tuple(float(row_bits * t * e) for t, e in zip(n_tx, erased)))
