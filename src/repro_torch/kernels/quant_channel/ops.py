"""Packed-wire wrappers: CUDA tensors launch the sm_90a kernels in
``csrc/quant_channel.cu`` (which replace the Pallas `packed_wire_2d`,
`packed_wire_mean_2d`, `quant_channel_2d` and `packed_wire_2d`'s
in-kernel-RNG mode), CPU tensors run the plain versions in ``ref.py``.
There is no fallback: a CUDA call builds and launches the kernel or
raises. Each wrapper counts its kernel launches in its ``launches``
attribute (and nowhere else).

Random words enter as 32-bit patterns: int64 tensors holding [0, 2^32)
(what `Draws.words` gives) or int32 bit patterns; `words_u32` turns
either into the int32 view the kernels read as uint32.

`DEVICE_KERNEL_RNG` (off by default) makes the packed wire draw its
words inside the kernel (K6) from one seed word per send instead of a
host-drawn word per element: a different stream, so host-vs-card parity
holds only with it off. It exists only on the card; on the CPU, where
nothing runs a kernel, the K6 wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant_channel.ref import (BLOCK_M, BLOCK_N,
                                                   packed_wire_mean_ref,
                                                   packed_wire_ref,
                                                   quant_channel_ref)

DEVICE_KERNEL_RNG = False

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_CODE_BYTES = {"float32": 4, "int8": 1, "int4": 1}
# threads per CTA at most, column vectors per CTA row at most
MAX_THREADS, MAX_TX = 256, 64
# K5: threads per CTA at most, elements a thread holds in registers,
# column loads across a CTA at most (csrc/quant_channel.cu), and CTAs a
# cluster at most: the non-portable 16, which beat the portable 8 on the
# H100 (PERF.md)
QC_MAX_THREADS, QC_WORDS, QC_TX = 512, 16, 128
CLUSTER_MAX = 16


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("quant_channel")
    lib.packed_wire.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    lib.packed_wire_philox.argtypes = [_P] * 4 + [_I] * 6 + [_U, _P]
    lib.packed_wire_mean.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.quant_channel.argtypes = [_P] * 4 + [_I] * 9 + [_P]
    for f in (lib.packed_wire, lib.packed_wire_philox, lib.packed_wire_mean,
              lib.quant_channel):
        f.restype = _I
    return lib


def wire_geometry(rows: int, cols: int, sms: int) -> tuple:
    """CTA shape (tx, ry) of K1, K2 and K6 over a [rows, cols] buffer on
    a card of `sms` SMs: one thread per 16-byte vector (4 elements), tx
    column vectors by ry rows per CTA, at most MAX_THREADS threads. ry
    halves from MAX_THREADS // tx while the grid would leave an SM
    without a CTA."""
    vc = cols // 4
    if rows >= 2 ** 31 or vc > MAX_TX * 65535:
        raise ValueError(f"packed wire: [{rows}, {cols}] is outside the "
                         f"kernels' grid (rows < 2^31, cols <= "
                         f"{4 * MAX_TX * 65535})")
    tx = max(1, min(vc, MAX_TX))
    ry = MAX_THREADS // tx
    while ry > 1 and -(-rows // ry) * -(-vc // tx) < sms:
        ry //= 2
    return tx, ry


def qc_geometry(M: int, N: int, sms: int, vec: int | None = None) -> tuple:
    """K5's launch over x [M, N] on a card of `sms` SMs: (cluster,
    rows_per_cta, threads). Each (min(128, M) x min(512, N)) tile is one
    cluster of CTAs, each CTA a contiguous slice of rows_per_cta of the
    tile's rows (the last may have fewer); a thread holds QC_WORDS
    elements, loaded `vec` (4 where the tile's width allows, else 1) at
    a time, tx = min(bn / vec, QC_TX) loads across a CTA and
    threads // tx rows down. The cluster is as large as spreads the
    tiles over the SMs, at most CLUSTER_MAX and the tile's rows, and at
    least what holds the tile in registers. Raises ValueError where the
    shape is not whole tiles or no cluster up to CLUSTER_MAX holds a
    tile."""
    if M < 1 or N < 1:
        raise ValueError(f"quant_channel_2d: empty x [{M}, {N}]")
    bm, bn = min(BLOCK_M, M), min(BLOCK_N, N)
    if M % bm or N % bn:
        raise ValueError(f"quant_channel_2d: {M} x {N} is not a whole "
                         f"number of {bm} x {bn} tiles")
    if vec is None:
        vec = 4 if bn % 4 == 0 else 1
    if vec not in (1, 4) or bn % vec:
        raise ValueError(f"quant_channel_2d: loads of {vec} elements do "
                         f"not tile a width of {bn}")
    vc = bn // vec
    tx = min(vc, QC_TX)
    col_passes = -(-vc // tx)
    n_tiles = (M // bm) * (N // bn)
    top = min(CLUSTER_MAX, bm)
    for c in range(max(1, min(top, -(-sms // n_tiles))), top + 1):
        rows = -(-bm // c)
        threads = -(-tx * min(rows, QC_MAX_THREADS // tx) // 32) * 32
        if col_passes * -(-rows // (threads // tx)) * vec <= QC_WORDS:
            return -(-bm // rows), rows, threads
    raise ValueError(f"quant_channel_2d: a {bm} x {bn} tile does not fit "
                     f"the registers of {top} CTAs of {QC_MAX_THREADS} "
                     f"threads")


def _grid(buf: torch.Tensor, rows: int) -> tuple:
    return wire_geometry(rows, buf.shape[1],
                         build.sm_count(buf.device.index))


def words_u32(rand: torch.Tensor, device=None) -> torch.Tensor:
    """32-bit words (int64 in [0, 2^32) or int32 patterns) as a
    contiguous int32 tensor on `device` (default: where they are),
    converted before the copy so that half the bytes move."""
    if rand.dtype == torch.int64:
        rand = torch.where(rand >= 2 ** 31, rand - 2 ** 32, rand) \
            .to(torch.int32)
    elif rand.dtype != torch.int32:
        raise ValueError(f"rand words must be int64 or int32, got "
                         f"{rand.dtype}")
    return rand.to(device if device is not None else rand.device) \
        .contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(what: str, bits: int, wire_dtype: str, buf, rows_vecs=(),
           words=None):
    if wire_dtype not in _CODE_BYTES:
        raise ValueError(f"{what}: unknown wire_dtype {wire_dtype!r}")
    if not 1 <= bits <= (8 if _CODE_BYTES[wire_dtype] == 1 else 31):
        raise ValueError(f"{what}: {bits} bits on a {wire_dtype} wire")
    if buf.ndim != 2 or buf.dtype != torch.float32 or buf.shape[1] % 4:
        raise ValueError(f"{what}: buf must be [R, C] float32 with C a "
                         f"multiple of 4, got {tuple(buf.shape)} "
                         f"{buf.dtype}")
    for name, t in rows_vecs:
        if t.shape != (buf.shape[0], 1) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be [{buf.shape[0]}, 1] "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    for t in (buf, words) + tuple(t for _, t in rows_vecs):
        if t is None:
            continue
        if t.device != buf.device or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous on "
                             f"{buf.device}")
    if words is not None and (words.shape != buf.shape
                              or words.dtype != torch.int32):
        raise ValueError(f"{what}: rand must be int32 words of "
                         f"{tuple(buf.shape)} (see words_u32)")


def packed_wire_2d(buf: torch.Tensor, rand: torch.Tensor,
                   scale_row: torch.Tensor, p_row: torch.Tensor, bits: int,
                   wire_dtype: str = "float32") -> torch.Tensor:
    """K1. buf [R, C] f32, rand [R, C] 32-bit words, scale_row/p_row
    [R, 1] f32 -> [R, C] f32: per-row b-bit quantize, flip, dequantize
    (the `wire_dtype` picks the codeword width: uint32, or uint8 for
    int8 and int4). One launch per tree, or per stacked N-user upload."""
    if not buf.is_cuda:
        return packed_wire_ref(buf, rand, scale_row, p_row, bits,
                               wire_dtype)
    rand = words_u32(rand)
    _check("packed_wire_2d", bits, wire_dtype, buf,
           (("scale_row", scale_row), ("p_row", p_row)), rand)
    out = torch.empty_like(buf)
    R, C = buf.shape
    st = _lib().packed_wire(buf.data_ptr(), rand.data_ptr(),
                            scale_row.data_ptr(), p_row.data_ptr(),
                            out.data_ptr(), R, C, *_grid(buf, R), bits,
                            _CODE_BYTES[wire_dtype], _stream(buf))
    build.check(st, "packed_wire")
    packed_wire_2d.launches += 1
    return out


def packed_wire_2d_philox(buf: torch.Tensor, scale_row: torch.Tensor,
                          p_row: torch.Tensor, bits: int, seed: int,
                          wire_dtype: str = "float32") -> torch.Tensor:
    """K6: K1 with the words drawn in the kernel by Philox4x32-10 from
    `seed` (`ref.philox_words` gives the same words). Card only."""
    if not buf.is_cuda:
        raise ValueError(
            "packed_wire_2d_philox draws its words inside the CUDA kernel "
            "and has no CPU path; the CPU keeps host-drawn words "
            "(DEVICE_KERNEL_RNG off)")
    _check("packed_wire_2d_philox", bits, wire_dtype, buf,
           (("scale_row", scale_row), ("p_row", p_row)))
    out = torch.empty_like(buf)
    R, C = buf.shape
    st = _lib().packed_wire_philox(
        buf.data_ptr(), scale_row.data_ptr(), p_row.data_ptr(),
        out.data_ptr(), R, C, *_grid(buf, R), bits,
        _CODE_BYTES[wire_dtype], int(seed) & 0xFFFFFFFF, _stream(buf))
    build.check(st, "packed_wire_philox")
    packed_wire_2d_philox.launches += 1
    return out


def packed_wire_mean_2d(buf: torch.Tensor, rand: torch.Tensor,
                        scale_row: torch.Tensor, p_row: torch.Tensor,
                        w_row: torch.Tensor, bits: int, n: int,
                        wire_dtype: str = "float32") -> torch.Tensor:
    """K2. buf/rand [N*R, C] (users stacked along rows), scale_row/
    p_row/w_row [N*R, 1] -> [R, C]: the weighted sum over users, in
    ascending order, of the received rows — the [N, R, C] received
    buffer never exists."""
    if not buf.is_cuda:
        return packed_wire_mean_ref(buf, rand, scale_row, p_row, w_row,
                                    bits, n, wire_dtype)
    rand = words_u32(rand)
    _check("packed_wire_mean_2d", bits, wire_dtype, buf,
           (("scale_row", scale_row), ("p_row", p_row), ("w_row", w_row)),
           rand)
    nr, c = buf.shape
    if n < 1 or nr % n:
        raise ValueError(f"packed_wire_mean_2d: {nr} rows for {n} users")
    out = torch.empty((nr // n, c), dtype=torch.float32, device=buf.device)
    st = _lib().packed_wire_mean(
        buf.data_ptr(), rand.data_ptr(), scale_row.data_ptr(),
        p_row.data_ptr(), w_row.data_ptr(), out.data_ptr(), nr // n, c,
        *_grid(buf, nr // n), n, bits, _CODE_BYTES[wire_dtype], _stream(buf))
    build.check(st, "packed_wire_mean")
    packed_wire_mean_2d.launches += 1
    return out


def quant_channel_2d(x: torch.Tensor, rand: torch.Tensor, p: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """K5. x [M, N] f32, rand [M, N] words, p [1] f32 (bit error
    probability): one amax scale per (min(128, M) x min(512, N)) tile."""
    M, N = x.shape
    bm, bn = min(BLOCK_M, M), min(BLOCK_N, N)
    if M % bm or N % bn:
        raise ValueError(f"quant_channel_2d: {M} x {N} is not a whole "
                         f"number of {bm} x {bn} tiles")
    if not x.is_cuda:
        return quant_channel_ref(x, rand, p, bits)
    rand = words_u32(rand)
    p = p.reshape(1).float().contiguous()
    if x.dtype != torch.float32 or not x.is_contiguous() \
            or rand.shape != x.shape or p.device != x.device \
            or rand.device != x.device or not 1 <= bits <= 31:
        raise ValueError("quant_channel_2d: x [M, N] float32, rand [M, N] "
                         "and p [1] on one device, 1 <= bits <= 31")
    # 16-byte loads where the tile's width and both inputs' addresses
    # allow them
    vec = 4 if bn % 4 == 0 and x.data_ptr() % 16 == 0 \
        and rand.data_ptr() % 16 == 0 else 1
    cluster, rows, threads = qc_geometry(
        M, N, build.sm_count(x.device.index), vec)
    out = torch.empty_like(x)
    st = _lib().quant_channel(x.data_ptr(), rand.data_ptr(), p.data_ptr(),
                              out.data_ptr(), M, N, bm, bn, cluster, rows,
                              threads, vec, bits, _stream(x))
    build.check(st, "quant_channel")
    quant_channel_2d.launches += 1
    return out


def transmit(draws, x: torch.Tensor, bits: int = 8, snr_db: float = 20.0,
             fading: bool = True) -> torch.Tensor:
    """Quantize+channel+dequantize `x` (any shape, float) through K5
    with per-BLOCK scales: one Rayleigh fade ("fade", a scalar), one
    word per padded element ("flip")."""
    dev = x.device
    if fading:
        f2 = -torch.log(draws.uniform("fade", (), 1e-12, 1.0))
    else:
        f2 = torch.tensor(1.0)
    p = draws.bit_error_prob(snr_db, f2).reshape(1).float().to(dev)
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    cols = BLOCK_N if n >= BLOCK_N else n
    rows = -(-n // cols)
    bm = min(BLOCK_M, rows)
    rows_p = rows + (-rows) % bm
    x2 = torch.zeros(rows_p * cols, dtype=torch.float32, device=dev)
    x2[:n] = flat
    x2 = x2.reshape(rows_p, cols)
    rand = draws.words("flip", x2.shape)
    y = quant_channel_2d(x2, words_u32(rand, dev), p, bits)
    return y.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


packed_wire_2d.launches = 0
packed_wire_2d_philox.launches = 0
packed_wire_mean_2d.launches = 0
quant_channel_2d.launches = 0
