"""Digital modulation options — the port of `repro/core/modulation.py`
(beyond-paper extension #2).

The paper fixes BPSK. Higher-order square M-QAM trades BER for
bandwidth: log2(M) bits/symbol means transmission time (and comm energy
at fixed power, Eq. 11's P/C accounting) scales by 1/log2(M), while the
per-bit error rate rises. The standard Gray-coded approximation:

    Pb ≈ 4/log2(M) · (1 − 1/√M) · Q( sqrt(3·log2(M)/(M−1) · SNR_b) )

(BPSK and QPSK: Q(sqrt(2 SNR_b)).) Q's argument is formed in float32 in
the JAX package's order, each step correctly rounded; Q itself is
evaluated in float64 and rounded once, the precision of the port's BPSK
p (core/channel.py `bpsk_bit_error_prob`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import channel as CH
from repro_torch.core import quantization as Q

SUPPORTED = ("bpsk", "qpsk", "16qam", "64qam")
_M = {"bpsk": 2, "qpsk": 4, "16qam": 16, "64qam": 64}


def bits_per_symbol(modulation: str) -> int:
    return int(math.log2(_M[modulation]))


def _qfunc(arg: torch.Tensor) -> torch.Tensor:
    """Q(arg) = 0.5 erfc(arg / sqrt 2) for a float32 `arg`, as float32."""
    x = arg / torch.tensor(math.sqrt(2.0), dtype=torch.float32)
    return (0.5 * torch.special.erfc(x.double())).float()


def _sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (torch's float32 sqrt on the CPU
    is off by an ulp for some inputs)."""
    return torch.sqrt(v.double()).float()


def bit_error_prob(modulation: str, snr_db, f2=1.0) -> torch.Tensor:
    """Gray-coded bit error probability at per-BIT SNR `snr_db`, scaled
    by the Rayleigh power gain f2 (float32, on the CPU)."""
    f2 = torch.as_tensor(f2, dtype=torch.float32).cpu()
    snr_b = f2 * CH.snr_linear(snr_db)
    M = _M[modulation]
    if M in (2, 4):     # QPSK == two orthogonal BPSK at the same Eb/N0
        return _qfunc(_sqrt_f32(2.0 * snr_b))
    k = math.log2(M)
    arg = _sqrt_f32(3.0 * k / (M - 1.0) * snr_b)
    return (4.0 / k) * (1.0 - 1.0 / math.sqrt(M)) * _qfunc(arg)


def transmit_quantized_mod(draws, x: torch.Tensor, bits: int,
                           snr_db: float, modulation: str = "bpsk",
                           fading: bool = True):
    """Quantized transmission with a selectable constellation, on
    `draws` ("fade": one Rayleigh draw, "flip": one word per element).
    Returns (x_hat, dict(ber=..., f2=..., symbols=...))."""
    q, s = Q.quantize(x, bits, scale=Q.scale_divided(x, bits))
    f2 = CH.rayleigh_gain(draws) if fading \
        else torch.tensor(1.0, dtype=torch.float32)
    p = bit_error_prob(modulation, snr_db, f2)
    code = Q.quantize_offset(q, bits)
    code = CH.flip_bits(draws, code, bits, p.to(x.device))
    q_hat = Q.unquantize_offset(code, bits)
    n_sym = int(x.numel()) * bits / bits_per_symbol(modulation)
    return Q.dequantize(q_hat, s, x.dtype), {"ber": p, "f2": f2,
                                             "symbols": n_sym}


def comm_time_scale(modulation: str) -> float:
    """Transmission-time (and energy, at fixed tx power) multiplier
    relative to BPSK for the same payload bits."""
    return 1.0 / bits_per_symbol(modulation)
