"""Wireless channel: Rayleigh fading + AWGN over BPSK (paper Eq. 10) —
the token path of `repro/core/channel.py`.

With BPSK, coherent detection and a known fade f, each bit flips
independently with p = Q(sqrt(2 |f|^2 SNR)), so the modulate / fade /
demodulate chain is XOR-ing the codewords with Bernoulli(p) bit noise.
Plane b of a codeword flips iff fmix32(word ^ (b+1)*GOLDEN) < p * 2^32,
from ONE 32-bit random word per element (core/wire.py). Random numbers
come through the `Draws` seam (core/draws.py).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import wire as W


def snr_linear(snr_db) -> torch.Tensor:
    return 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)


def bpsk_bit_error_prob(snr_db, f2) -> torch.Tensor:
    """p = Q(sqrt(2 |f|^2 SNR)) for coherent BPSK, in float32."""
    f2 = torch.as_tensor(f2, dtype=torch.float32)
    arg = torch.sqrt(2.0 * f2 * snr_linear(snr_db))
    return 0.5 * torch.special.erfc(arg / math.sqrt(2.0))


def flip_bits(draws, codewords: torch.Tensor, n_bits: int, p) -> torch.Tensor:
    """XOR codewords (int64 holding values < 2^n_bits) with iid
    Bernoulli(p) bits; one "flip" word per element. `p` broadcasts
    against `codewords` (per-row fading)."""
    rand = draws.words("flip", codewords.shape)
    return codewords ^ W.bit_flip_mask(rand, n_bits, p)


def transmit_tokens(draws, tokens: torch.Tensor, vocab_size: int,
                    snr_db: float, fading: bool = True) -> torch.Tensor:
    """CL / serving uplink: raw token ids cross the channel as fixed-width
    codewords, one Rayleigh fade per ROW (one packet per row)."""
    n_bits = max(1, (int(vocab_size) - 1).bit_length())
    if fading:
        n_rows = tokens.shape[0] if tokens.ndim > 1 else 1
        u = draws.uniform("fade", (n_rows,), 1e-12, 1.0)
        f2 = -torch.log(u)
        if tokens.ndim > 1:
            f2 = f2.reshape((n_rows,) + (1,) * (tokens.ndim - 1))
    else:
        f2 = torch.tensor(1.0, dtype=torch.float32)
    p = bpsk_bit_error_prob(snr_db, f2)
    code = flip_bits(draws, tokens.long() & W.M32, n_bits, p)
    return torch.clamp(code, max=vocab_size - 1).to(tokens.dtype)
