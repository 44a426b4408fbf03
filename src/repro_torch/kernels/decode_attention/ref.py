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
