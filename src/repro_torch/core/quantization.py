"""b-bit symmetric quantization, paper Eq. (1)-(2) — the port of
`repro/core/quantization.py`, bit-exact with it:

    S = max|W| / (2^{b-1} - 1)         (scale)
    Q = round(W / S)                   (levels, round half to even)
    W_hat = Q * S                      (dequantize)

Codewords are int64 tensors holding unsigned values (torch has no
uint32 arithmetic on the CPU); the int4 wire packs two per uint8.
`quantize_ste` is the straight-through estimator for use inside a
differentiated forward pass.
"""
from __future__ import annotations

import numpy as np
import torch


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def f32_reciprocal(n: int) -> float:
    """The float32 reciprocal of `n` (exactly representable, so a
    float32 tensor times it is one float32 product on any device)."""
    return float(np.float32(1.0) / np.float32(n))


def scale_from_amax(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """amax * float32(1 / qmax). The JAX package's compiled paths divide
    by the constant qmax as a product with its float32 reciprocal (XLA's
    rewrite of a division by a constant), which differs from a true
    division in the last ulp for some amax; every port scale is this
    product, to match them bit for bit."""
    return torch.clamp(amax, min=1e-12) * f32_reciprocal(qmax(bits))


def scale_for(x: torch.Tensor, bits: int) -> torch.Tensor:
    return scale_from_amax(torch.max(torch.abs(x)), bits)


def scale_divided(x: torch.Tensor, bits: int) -> torch.Tensor:
    """max(amax, 1e-12) / qmax as a true division: the JAX package's
    eagerly run helpers (core/coding.py, core/modulation.py) divide, as
    its compiled paths do not (a tensor divisor, because torch on CUDA
    turns a division by a Python scalar into a reciprocal product)."""
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    return amax / torch.full_like(amax, qmax(bits))


def stochastic_round(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Unbiased rounding: floor(x) + 1 w.p. frac(x); `u` supplies the
    uniform [0, 1) draw per element."""
    lo = torch.floor(x)
    return lo + (u < (x - lo)).to(x.dtype)


def quantize(x: torch.Tensor, bits: int, scale=None, u=None):
    """-> (q int32 in [-qmax, qmax], scale). With `u` (uniform [0, 1)
    per element), rounds stochastically instead of to nearest."""
    s = scale_for(x, bits) if scale is None else scale
    r = torch.round(x / s) if u is None else stochastic_round(x / s, u)
    q = torch.clamp(r, -qmax(bits), qmax(bits)).to(torch.int32)
    return q, s


def dequantize(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_offset(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Map signed levels to unsigned codewords [0, 2^b) for bit
    transport (int64 holding the unsigned value)."""
    return (q.long() + qmax(bits)) & 0xFFFFFFFF


def unquantize_offset(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Received codewords can exceed the signed range after bit errors
    (a flipped top bit gives up to 2*qmax + 1): clip. The JAX package
    reinterprets the uint32 codeword as int32 first, which the
    wrap-around below repeats."""
    v = u.long() & 0xFFFFFFFF
    v = torch.where(v >= 2 ** 31, v - 2 ** 32, v)
    return torch.clamp(v - qmax(bits), -qmax(bits), qmax(bits)).to(
        torch.int32)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        q, s = quantize(x, bits)
        return dequantize(q, s, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quantize_ste(x: torch.Tensor, bits: int) -> torch.Tensor:
    return _QuantizeSTE.apply(x, bits)


def payload_bits(x: torch.Tensor, bits: int) -> int:
    """Transmitted payload size of ONE tensor at b-bit quantization."""
    return int(x.numel()) * bits


def pack_nibbles(code: torch.Tensor) -> torch.Tensor:
    """[..., C] codewords (each < 16) -> [..., C // 2] uint8, adjacent
    pairs packed little-end-first: byte = even | (odd << 4)."""
    lo = code[..., 0::2].to(torch.uint8)
    hi = code[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_nibbles: [..., C // 2] uint8 -> [..., C] int32."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])
