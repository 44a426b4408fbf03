"""Prefill attention wrappers: CUDA tensors launch the sm_90a kernels in
``csrc/prefill_attention.cu`` (which replace the Pallas `_prefill_kernel`
and `_paged_prefill_kernel`), CPU tensors run the plain versions in
``ref.py``. Dense and paged run the same kernels, templated on where a KV
column lives: bf16 on the tensor cores, f32 on the CUDA-core body of
``kernels/csrc/flash_tile.cuh``; on the same data they give the same bits.
There is no fallback: a CUDA call builds and launches the kernel or
raises. Each wrapper counts its kernel launches in its ``launches``
attribute (and nowhere else)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.prefill_attention.ref import (
    paged_prefill_attention_ref, prefill_attention_ref)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def prefill_smem_bytes(hd: int, dtype, n_lp: int, page: int = 16,
                       window: int = 0) -> int:
    """Shared memory of one paged prefill CTA at a table row of n_lp
    pages of `page`: the row base, 8 bytes, of every page the CTA's span
    may touch, beside the bf16 tensor-core body's K / V stages (4 warps x 2
    stages x K and V x a tile of 64 columns at hd 64, 32 at 128, 16
    padded to 168 elements at 160, in bf16) or the f32 body's static
    tiles (flash_tile.cuh: Q of 16 rows, K padded by one, V and P of 32
    columns, 16 at 160, and three row vectors, in f32). The span is the
    whole row, or under a window (kv_cols.cuh's `stage_pages`) window +
    reach columns: a bf16 CTA's at most 64 rows reach 63 positions past
    its first, an f32 CTA's 16 rows 15 and its tile-aligned start a tile
    less one."""
    if dtype == torch.bfloat16:
        cols = 16 if hd == 160 else 8192 // (2 * hd)
        pitch = hd + 8 if hd == 160 else hd
        base = 4 * 2 * 2 * cols * pitch * 2
        reach = 63
    else:
        tile = 16 if hd > 128 else 32
        base = 4 * (16 * hd + tile * (hd + 1) + tile * hd + 16 * tile
                    + 3 * 16)
        # ptxas lays these out in whole 128-byte lines (an sm_90a build:
        # 22,912, 43,392 and 32,000 bytes at hd 64, 128 and 160)
        base = -(-base // 128) * 128
        reach = 15 + tile - 1
    pages = n_lp if window <= 0 else min(
        n_lp, -(-(window + reach) // page) + 1)
    return base + 8 * pages


def check_paged_prefill(hd: int, dtype, page: int, n_lp: int,
                        window: int = 0) -> None:
    """Refuse, before launch, a table row whose pages one CTA's shared
    memory cannot stage at this window (raises ValueError naming the
    limit and the longest cache the kernel takes there)."""
    build.check_staging(
        "gqa_prefill_paged",
        lambda n: prefill_smem_bytes(hd, dtype, n, page, window),
        n_lp, page)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("prefill_attention")
    lib.prefill_attention.argtypes = [_P] * 5 + [_I] * 7 + [_F, _I, _P]
    lib.paged_prefill_attention.argtypes = [_P] * 6 + [_I] * 9 \
        + [_F, _I, _P]
    lib.prefill_attention.restype = _I
    lib.paged_prefill_attention.restype = _I
    return lib


def gqa_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, start, window: int = 0) -> torch.Tensor:
    """q [B, C, H, hd] — a C-token prompt chunk per slot; caches
    [B, Hkv, S, hd] already holding the chunk's own K/V columns;
    `start` [B] per-row global position of chunk token 0.
    Returns [B, C, H, hd] f32."""
    if not q.is_cuda:
        return prefill_attention_ref(q, k_cache, v_cache, start,
                                     window=window).float()
    B, C, H, hd = q.shape
    _, Hkv, S, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != hd or H % Hkv:
        raise ValueError(f"gqa_prefill: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    code = build.attention_args("gqa_prefill", q, k_cache, v_cache, hd)
    st_rows = build.int_rows(start, B, q.device)
    out = torch.empty((B, C, H, hd), dtype=torch.float32, device=q.device)
    st = _lib().prefill_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        st_rows.data_ptr(), B, Hkv, H // Hkv, C, S, hd, int(window),
        1.0 / hd ** 0.5, code, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(st, "prefill_attention")
    gqa_prefill.launches += 1
    return out


def gqa_prefill_paged(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, tables, start,
                      window: int = 0) -> torch.Tensor:
    """q [B, C, H, hd] prompt chunks; pools [n_pages, Hkv, page, hd]
    already holding the chunk's own K/V columns; `tables` [B, n_lp]
    per-slot page tables; `start` [B]. Returns [B, C, H, hd] f32. A
    table row whose pages one CTA cannot stage at this window
    (`check_paged_prefill`) raises before launch."""
    if not q.is_cuda:
        return paged_prefill_attention_ref(q, k_pool, v_pool, tables, start,
                                           window=window).float()
    B, C, H, hd = q.shape
    n_pages, Hkv, page, _ = k_pool.shape
    if k_pool.shape[3] != hd or H % Hkv:
        raise ValueError(f"gqa_prefill_paged: q {tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)}")
    code = build.attention_args("gqa_prefill_paged", q, k_pool, v_pool, hd)
    tbl = build.int_table(tables, B, q.device)
    check_paged_prefill(hd, q.dtype, page, tbl.shape[1], int(window))
    st_rows = build.int_rows(start, B, q.device)
    out = torch.empty((B, C, H, hd), dtype=torch.float32, device=q.device)
    st = _lib().paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tbl.data_ptr(), st_rows.data_ptr(), B, Hkv, H // Hkv, C, n_pages,
        page, tbl.shape[1], hd, int(window), 1.0 / hd ** 0.5, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(st, "paged_prefill_attention")
    gqa_prefill_paged.launches += 1
    return out


gqa_prefill.launches = 0
gqa_prefill_paged.launches = 0
