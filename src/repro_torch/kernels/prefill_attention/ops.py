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


def stage_pages(hd: int, dtype, n_lp: int, page: int = 16,
                window: int = 0) -> int:
    """Page bases one paged prefill CTA stages at a time at a table row
    of n_lp pages of `page` (8 bytes each, in shared memory beside the
    body's tiles; `build.stage_pages`): the pages of the CTA's span, at
    most build.STAGE_PAGES. The span is the whole row, or under a window
    window + reach columns: a bf16 CTA's at most 64 rows reach 63
    positions past its first, an f32 CTA's 16 rows 15 and its
    tile-aligned start a tile (32 columns, 16 at hd 160) less one."""
    if window <= 0:
        return build.stage_pages(n_lp * page, page, n_lp)
    reach = 63 if dtype == torch.bfloat16 else 15 + (
        16 if hd > 128 else 32) - 1
    return build.stage_pages(window + reach, page, n_lp)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("prefill_attention")
    lib.prefill_attention.argtypes = [_P] * 5 + [_I] * 7 + [_F, _I, _P]
    lib.paged_prefill_attention.argtypes = [_P] * 6 + [_I] * 10 \
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
    table row of any length launches, up to the columns the kernel's
    int32 indices address (`build.check_table`)."""
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
    build.check_table("gqa_prefill_paged", tbl.shape[1], page)
    st_rows = build.int_rows(start, B, q.device)
    out = torch.empty((B, C, H, hd), dtype=torch.float32, device=q.device)
    st = _lib().paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tbl.data_ptr(), st_rows.data_ptr(), B, Hkv, H // Hkv, C, n_pages,
        page, tbl.shape[1],
        stage_pages(hd, q.dtype, tbl.shape[1], page, int(window)), hd,
        int(window), 1.0 / hd ** 0.5, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(st, "paged_prefill_attention")
    gqa_prefill_paged.launches += 1
    return out


gqa_prefill.launches = 0
gqa_prefill_paged.launches = 0
