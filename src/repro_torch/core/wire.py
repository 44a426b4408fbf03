"""The packed wire's bit-plane RNG, ARQ draw and accounting — the part of
`repro/core/wire.py` that `Radio.send_tokens` needs (the packed
transmit paths and their kernels come with the wire slice).

Bit work is in int64 masked to 32 bits: torch on the CPU has no `>>`
or `<` on uint32, and an int64 product of two 32-bit values can
overflow, so `_mul32` splits the multiplier.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # per-bit-plane salt stride
_GE_FOLD = 77        # the JAX package's fold for the Gilbert-Elliott chain


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 on int64 words holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def bit_flip_mask(rand: torch.Tensor, n_bits: int, p) -> torch.Tensor:
    """XOR mask with each of the low `n_bits` planes set iid w.p. `p`,
    from ONE 32-bit word per element; `p` (float32) broadcasts against
    `rand`. The threshold is float32 p * 2^32 truncated, as in JAX."""
    thresh = (torch.as_tensor(p, dtype=torch.float32)
              * 4294967296.0).to(torch.int64)
    flips = torch.zeros_like(rand)
    for b in range(n_bits):
        salt = ((b + 1) * GOLDEN) & M32
        r = fmix32(rand ^ salt)
        flips = flips | ((r < thresh).to(torch.int64) << b)
    return flips


# ----------------------------------------------------------------- faults
def fault_free(fading: bool = True, perfect: bool = False,
               arq_attempts: int = 1, arq_min_f2: float = 0.25,
               arq_max_tx: int = 0, ge_p_gb: float = 0.0) -> bool:
    """True iff this knob combination can neither retransmit nor erase."""
    if perfect:
        return True
    if ge_p_gb > 0.0:
        return False
    if arq_max_tx > 0:
        return (not fading) and arq_min_f2 <= 1.0
    return (not fading) or arq_attempts <= 1


def _ge_bad_states(draws, n: int, n_packets: int, p_gb: float, p_bg: float):
    """[n, n_packets] bool bad-link states of the two-state
    Gilbert-Elliott chain (initial state from the stationary law)."""
    pi_bad = p_gb / max(p_gb + p_bg, 1e-12)
    bad = draws.uniform("ge_init", (n,), 0.0, 1.0) < pi_bad
    us = draws.uniform("ge_chain", (n_packets, n), 0.0, 1.0)
    out = []
    for t in range(n_packets):
        bad = torch.where(bad, us[t] >= p_bg, us[t] < p_gb)
        out.append(bad)
    return torch.stack(out, dim=1)


def backoff_s(n_tx, base_s: float):
    """Exponential-backoff wait of packets that took `n_tx`
    transmissions: base * (2^(k-1) - 1) each, summed (host f64)."""
    if base_s <= 0.0:
        return 0.0
    k = np.asarray(n_tx, np.float64)
    return float(base_s) * float(np.sum(np.exp2(k - 1.0) - 1.0))


def expected_arq_tx(attempts: int = 1, min_f2: float = 0.25,
                    fading: bool = True, perfect: bool = False) -> float:
    """Analytic expected transmissions per packet under outage-ARQ."""
    if attempts <= 1 or not fading or perfect:
        return 1.0
    p_out = 1.0 - math.exp(-min_f2)
    return (1.0 - p_out ** attempts) / (1.0 - p_out)


def _packet_fades(draws, n: int, n_packets: int, fading: bool,
                  arq_attempts: int, arq_min_f2: float,
                  arq_max_tx: int = 0, ge_p_gb: float = 0.0,
                  ge_p_bg: float = 0.5):
    """(|f|^2, n_tx, erased) per (user, packet) from ONE batched "arq"
    uniform draw — `repro.core.wire._packet_fades`."""
    ones = torch.ones((n, n_packets), dtype=torch.int64)
    no_erase = torch.zeros((n, n_packets), dtype=torch.bool)
    if arq_max_tx <= 0 and ge_p_gb <= 0.0:
        if not fading:
            return torch.ones((n, n_packets)), ones, no_erase
        if arq_attempts <= 1:
            u = draws.uniform("arq", (n, n_packets), 1e-12, 1.0)
            return -torch.log(u), ones, no_erase
        attempts = arq_attempts
    else:
        attempts = arq_max_tx if arq_max_tx > 0 else max(int(arq_attempts), 1)
    if fading:
        f2s = -torch.log(draws.uniform("arq", (n, n_packets, attempts),
                                       1e-12, 1.0))
    else:
        f2s = torch.ones((n, n_packets, attempts))
    ok = f2s >= arq_min_f2
    bad = no_erase
    if ge_p_gb > 0.0:
        bad = _ge_bad_states(draws, n, n_packets, ge_p_gb, ge_p_bg)
        ok = ok & ~bad[..., None]
    any_ok = ok.any(dim=-1)
    first = ok.to(torch.int64).argmax(dim=-1)
    idx = torch.where(any_ok, first, attempts - 1)
    n_tx = torch.where(any_ok, first + 1, attempts)
    f2 = torch.gather(f2s, -1, idx[..., None])[..., 0]
    f2 = torch.where(bad & ~any_ok, 0.0, f2)
    erased = (~any_ok) if arq_max_tx > 0 else no_erase
    return f2, n_tx, erased


def drawn_stacked_tx(draws, n: int, n_packets: int, fading: bool = True,
                     perfect: bool = False, arq_attempts: int = 1,
                     arq_min_f2: float = 0.25, arq_max_tx: int = 0,
                     ge_p_gb: float = 0.0, ge_p_bg: float = 0.5,
                     with_erased: bool = False):
    """Per-(user, packet) DRAWN transmission counts (host [n, n_packets]
    int64 array) of a stacked send, without transmitting; with
    `with_erased`, also the bool erasure mask."""
    if fault_free(fading, perfect, arq_attempts, arq_min_f2, arq_max_tx,
                  ge_p_gb):
        n_tx = np.ones((n, n_packets), np.int64)
        return (n_tx, np.zeros((n, n_packets), bool)) if with_erased \
            else n_tx
    _, n_tx, erased = _packet_fades(draws, n, n_packets, fading,
                                    arq_attempts, arq_min_f2, arq_max_tx,
                                    ge_p_gb, ge_p_bg)
    n_tx = n_tx.numpy()
    return (n_tx, erased.numpy()) if with_erased else n_tx


# --------------------------------------------------------------- accounting
def wire_width(wire_dtype: str, bits: int) -> int:
    """Billed on-air bits per codeword for a wire dtype."""
    if wire_dtype == "int8":
        return 8
    if wire_dtype == "int4":
        return 4
    return int(bits)


def payload_bits(tensors, bits: int, expected_tx: float = 1.0,
                 wire_dtype: str = "float32") -> float:
    """On-air payload of transmitting every tensor of `tensors` (one
    tensor or a list) at b-bit codewords, scaled by the expected (ARQ)
    transmission count."""
    if isinstance(tensors, (list, tuple)):
        n = sum(int(np.size(t)) if not torch.is_tensor(t) else t.numel()
                for t in tensors)
    else:
        n = tensors.numel() if torch.is_tensor(tensors) \
            else int(np.size(tensors))
    return float(n) * float(wire_width(wire_dtype, bits)) \
        * float(expected_tx)
