"""Plain PyTorch versions of the quant_channel kernels (K1, K2, K5, K6):
the same arithmetic in torch ops, on whatever device the tensors are.
The CPU path of every wrapper in ``ops.py``, and what ``chip_smoke.py``
holds each kernel against on the card.

`packed_wire_ref` IS the port's `core.wire.wire_transform` (per-row
scale and p), in the code width of `wire_dtype`; `packed_wire_mean_ref`
accumulates its users in ascending order, each product rounded to
float32 before the add; `quant_channel_ref` takes one amax scale per
(bm x bn) tile (amax times the float32 reciprocal of qmax, as the
compiled JAX kernel computes it) and a scalar p. `philox4x32_10` is the counter-based
generator of the in-kernel RNG (Salmon et al., SC'11), so K6 has an
exact plain version too.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.core import wire as W

BLOCK_M = 128
BLOCK_N = 512

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def packed_wire_ref(buf, rand, scale_row, p_row, bits: int,
                    wire_dtype: str = "float32") -> torch.Tensor:
    """buf [R, C] f32, rand [R, C] 32-bit words (int64 or int32 bit
    patterns), scale_row/p_row [R, 1] f32 -> [R, C] f32."""
    return W.wire_transform(buf, rand.long() & W.M32, scale_row, p_row,
                            bits,
                            code_dtype=("uint8" if wire_dtype == "int8"
                                        else "uint32"),
                            nibble_packed=(wire_dtype == "int4"))


def packed_wire_mean_ref(buf, rand, scale_row, p_row, w_row, bits: int,
                         n: int, wire_dtype: str = "float32"):
    """Users stacked along rows ([N*R, C], [N*R, 1]) -> [R, C]: the sum
    over users, in ascending order, of w * (received rows)."""
    nr, c = buf.shape
    y = packed_wire_ref(buf, rand, scale_row, p_row, bits, wire_dtype)
    prods = (w_row * y).reshape(n, nr // n, c)
    acc = torch.zeros((nr // n, c), dtype=torch.float32, device=buf.device)
    for u in range(n):
        acc = acc + prods[u]
    return acc


def quant_channel_ref(x, rand, p, bits: int) -> torch.Tensor:
    """x [M, N] f32, rand [M, N] words, p [1] f32: per-(bm x bn)-tile
    amax scale, then the wire math with a scalar p."""
    M, N = x.shape
    bm, bn = min(BLOCK_M, M), min(BLOCK_N, N)
    xb = x.reshape(M // bm, bm, N // bn, bn).transpose(1, 2)
    rb = (rand.long() & W.M32).reshape(M // bm, bm, N // bn, bn) \
        .transpose(1, 2)
    scale = Q.scale_from_amax(xb.abs().amax(dim=(-2, -1), keepdim=True),
                              bits)
    out = W.wire_transform(xb, rb, scale, p.reshape(()), bits)
    return out.transpose(1, 2).reshape(M, N)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for int64 `a` in [0, 2^32)."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & W.M32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter: torch.Tensor, key: tuple) -> torch.Tensor:
    """Philox4x32-10 of each [..., 4] int64 counter under the 2-word key
    -> [..., 4] int64 words in [0, 2^32)."""
    c = [counter[..., i] for i in range(4)]
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & W.M32, (k1 + _PHILOX_W[1]) & W.M32
        hi0, lo0 = _mulhilo(c[0], _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], _PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, dim=-1)


def philox_words(n_elem: int, seed: int, device) -> torch.Tensor:
    """The in-kernel generator's word for each of `n_elem` elements
    (a multiple of 4): element i is lane i % 4 of the block for counter
    (i // 4, 0, 0, 0) under key (seed, 0)."""
    g = torch.arange(n_elem // 4, dtype=torch.int64, device=device)
    ctr = torch.stack([g & W.M32, g >> 32, torch.zeros_like(g),
                       torch.zeros_like(g)], dim=-1)
    return philox4x32_10(ctr, (int(seed) & W.M32, 0)).reshape(-1)


def packed_wire_philox_ref(buf, scale_row, p_row, bits: int, seed: int,
                           wire_dtype: str = "float32") -> torch.Tensor:
    """K6's plain version: K1 on the words `philox_words` draws."""
    rand = philox_words(buf.numel(), seed, buf.device).reshape(buf.shape)
    return packed_wire_ref(buf, rand, scale_row, p_row, bits, wire_dtype)
