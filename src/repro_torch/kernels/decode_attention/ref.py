"""Plain PyTorch versions of the decode attention kernels — the math of
`repro.models.layers.decode_attention_jnp` / `paged_view` on tensors.
The CPU runs these; on the card they are only the kernels' yardstick."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, length, window: int = 0,
                         offset: int = 0):
    """One-token GQA attention against a cache. q [B,H,hd], caches
    [B,Hkv,S,hd], `length` = count of valid positions (a scalar or a
    per-row [B] vector); `offset` = global position of cache column 0.
    Returns [B,H,hd] in q's dtype."""
    B, Hkv, S, hd = k_cache.shape
    H = q.shape[1]
    G = H // Hkv
    qf = q.reshape(B, Hkv, G, hd)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.to(qf.dtype))
    logits = logits.float() / math.sqrt(hd)
    pos = offset + torch.arange(S, device=q.device)
    lth = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < lth
    if window:
        valid &= pos[None, :] >= lth - window
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, hd)


def paged_view(pool, tables):
    """Gather a slot-major dense view [B, Hkv, n_lp*page, hd] out of a
    shared page pool [n_pages, Hkv, page, hd] via per-slot page tables
    [B, n_lp]: logical column c of row b lives at
    pool[tables[b, c // page], :, c % page]."""
    B, n_lp = tables.shape
    n_pages, Hkv, page, hd = pool.shape
    v = pool[tables.long()]                          # [B, n_lp, Hkv, page, hd]
    return v.permute(0, 2, 1, 3, 4).reshape(B, Hkv, n_lp * page, hd)


def paged_decode_attention_ref(q, k_pool, v_pool, tables, length,
                               window: int = 0):
    """`decode_attention_ref` over the dense view of a paged pool."""
    return decode_attention_ref(q, paged_view(k_pool, tables),
                                paged_view(v_pool, tables), length,
                                window=window)


def decode_split_ranges(length, S: int, window: int, n_split: int):
    """The dense kernel's column ranges: the valid span of each row,
    [length - window, length) clipped to [0, S), cut into n_split equal
    contiguous ranges. Returns (lo, hi) int64 tensors [B, n_split]; a
    range with lo >= hi holds no column."""
    lth = torch.as_tensor(length).reshape(-1).long()
    hi = lth.clamp(max=S)
    lo = (lth - window).clamp(min=0) if window else torch.zeros_like(lth)
    span = (hi - lo).clamp(min=0)
    chunk = (span + n_split - 1) // n_split
    c_lo = lo[:, None] + torch.arange(n_split)[None] * chunk[:, None]
    return c_lo, torch.minimum(c_lo + chunk[:, None], hi[:, None])


def decode_attention_split_ref(q, k_cache, v_cache, length, window: int = 0,
                               n_split: int = 1):
    """Plain mirror of the dense decode kernel's algorithm, for the
    tests: per split an unnormalised partial (m, l, acc) over its own
    column range (an empty range gives m = NEG_INF, l = 0, acc = 0), then
    the partials merged in split order 0..n_split-1. p is rounded to V's
    dtype before p . V and l sums the unrounded p. Returns [B, H, hd]
    f32; a row with no valid column returns 0."""
    B, Hkv, S, hd = k_cache.shape
    H = q.shape[1]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.float()) / math.sqrt(hd)
    c_lo, c_hi = decode_split_ranges(length, S, window, n_split)
    pos = torch.arange(S)
    parts = []
    for i in range(n_split):
        ok = (pos[None] >= c_lo[:, i:i + 1]) & (pos[None] < c_hi[:, i:i + 1])
        ok = ok[:, None, None, :]                       # [B, 1, 1, S]
        m = s.masked_fill(~ok, NEG_INF).amax(-1, keepdim=True)
        p = torch.where(ok, torch.exp(s - m), torch.zeros(()))
        acc = torch.einsum("bhgs,bhsd->bhgd",
                           p.to(v_cache.dtype).float(), v_cache.float())
        parts.append((m, p.sum(-1, keepdim=True), acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum, acc = 0.0, 0.0
    for m, l, a in parts:
        c = torch.exp(m - mx)
        lsum = lsum + l * c
        acc = acc + a * c
    return (acc / lsum.clamp(min=1e-30)).reshape(B, H, hd)


def paged_decode_attention_split_ref(q, k_pool, v_pool, tables, length,
                                     window: int = 0, n_split: int = 1):
    """Plain mirror of the paged decode kernel, for the tests: the dense
    mirror over the pool's columns as the kernel addresses them, S =
    n_lp * page and page ids clamped into [0, n_pages). Returns
    [B, H, hd] f32; a row with no valid column returns 0."""
    ids = torch.as_tensor(tables).long().clamp(0, k_pool.shape[0] - 1)
    return decode_attention_split_ref(q, paged_view(k_pool, ids),
                                      paged_view(v_pool, ids), length,
                                      window=window, n_split=n_split)
