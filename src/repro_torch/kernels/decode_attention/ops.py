"""Decode attention wrappers: CUDA tensors launch the sm_90a kernels in
``csrc/decode_attention.cu`` (which replace the Pallas `_decode_kernel`
and `_paged_decode_kernel`), CPU tensors run the plain versions in
``ref.py``. There is no fallback: a CUDA call builds and launches the
kernel or raises. Each wrapper counts its kernel launches in its
``launches`` attribute (and nowhere else): one per call, also where the
split-KV kernel adds its merge launch. Dense and paged run the same
split-KV kernel, templated on where a KV column lives, with a split
count that depends on neither layout's column count, so on the same
data they give the same bits."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the kernel aims for three CTAs per SM of the H100's 132 (at the
# serving shape, 8 slots x 16 KV heads, that is 4 splits, which beat 1, 2,
# 3, 6 and 9 in chip_smoke.py's sweep) with at most MAX_SPLITS splits.
# The count is not capped by the cache's column count: a dense cache of
# S columns and its paged copy of ceil(S / page) * page columns would get
# different counts, and sum a row in different orders
TARGET_CTAS = 3 * 132
MAX_SPLITS = 8


def group_rows(G: int) -> int:
    """Head-group rows per CTA of the kernel (1, 2 or 4; a G above
    4 takes ceil(G / 4) CTAs per KV head and split)."""
    return G if G <= 2 else 4


def decode_splits(B: int, Hkv: int, G: int) -> int:
    """KV splits per (slot, KV head, head-group block) of the kernel: the
    least n with B * Hkv * ceil(G / group_rows(G)) * n >= TARGET_CTAS,
    capped at MAX_SPLITS. The batch and head shapes only, which the
    dense and the paged layout share, so no per-slot length is ever
    read back to the host and both layouts split a row alike."""
    units = B * Hkv * -(-G // group_rows(G))
    return max(1, min(-(-TARGET_CTAS // units), MAX_SPLITS))


def stage_pages(n_lp: int, page: int, n_split: int) -> int:
    """Page bases one paged decode CTA stages at a time (8 bytes each, in
    shared memory beside the warps' merge buffer; `build.stage_pages`):
    the pages one split's share of a table row of n_lp pages can touch,
    at most build.STAGE_PAGES."""
    return build.stage_pages(-(-n_lp * page // n_split), page, n_lp)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("decode_attention")
    lib.decode_attention.argtypes = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
    lib.paged_decode_attention.argtypes = [_P] * 7 + [_I] * 11 \
        + [_F, _I, _P]
    lib.decode_attention.restype = _I
    lib.paged_decode_attention.restype = _I
    return lib


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               length, window: int = 0) -> torch.Tensor:
    """q [B, H, hd]; caches [B, Hkv, S, hd]; `length` a scalar or a
    per-row [B] vector of valid-prefix counts. Returns [B, H, hd] f32.
    On the card a row of length 0 returns zeros (its slot is idle). The
    kernel splits each row's span over `decode_splits` CTAs and merges
    their partials, in split order, from a workspace allocated here."""
    if not q.is_cuda:
        return decode_attention_ref(q, k_cache, v_cache, length,
                                    window=window).float()
    B, H, hd = q.shape
    _, Hkv, S, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != hd or H % Hkv:
        raise ValueError(f"gqa_decode: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    code = build.attention_args("gqa_decode", q, k_cache, v_cache, hd)
    lengths = build.int_rows(length, B, q.device)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    G = H // Hkv
    n_split = decode_splits(B, Hkv, G)
    ws = torch.empty((B, H, n_split, hd + 2) if n_split > 1 else (0,),
                     dtype=torch.float32, device=q.device)
    st = _lib().decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        ws.data_ptr(), lengths.data_ptr(), B, Hkv, G, S, hd, group_rows(G),
        n_split, int(window), 1.0 / hd ** 0.5, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(st, "decode_attention")
    gqa_decode.launches += 1
    return out


def gqa_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, tables, length,
                     window: int = 0) -> torch.Tensor:
    """q [B, H, hd]; pools [n_pages, Hkv, page, hd]; `tables` [B, n_lp]
    per-slot page tables; `length` scalar or per-row [B] valid-prefix
    counts. Returns [B, H, hd] f32. The dense kernel's split-KV body
    over n_lp * page columns; page ids are clamped into the pool. A
    table row of any length launches, up to the columns the kernel's
    int32 indices address (`build.check_table`)."""
    if not q.is_cuda:
        return paged_decode_attention_ref(q, k_pool, v_pool, tables, length,
                                          window=window).float()
    B, H, hd = q.shape
    n_pages, Hkv, page, _ = k_pool.shape
    if k_pool.shape[3] != hd or H % Hkv:
        raise ValueError(f"gqa_decode_paged: q {tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)}")
    code = build.attention_args("gqa_decode_paged", q, k_pool, v_pool, hd)
    tbl = build.int_table(tables, B, q.device)
    lengths = build.int_rows(length, B, q.device)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    G, n_lp = H // Hkv, tbl.shape[1]
    build.check_table("gqa_decode_paged", n_lp, page)
    n_split = decode_splits(B, Hkv, G)
    ws = torch.empty((B, H, n_split, hd + 2) if n_split > 1 else (0,),
                     dtype=torch.float32, device=q.device)
    st = _lib().paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        ws.data_ptr(), tbl.data_ptr(), lengths.data_ptr(), B, Hkv, G,
        n_pages, page, n_lp, stage_pages(n_lp, page, n_split), hd,
        group_rows(G), n_split, int(window), 1.0 / hd ** 0.5, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(st, "paged_decode_attention")
    gqa_decode_paged.launches += 1
    return out


gqa_decode.launches = 0
gqa_decode_paged.launches = 0
