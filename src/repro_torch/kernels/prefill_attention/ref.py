"""Plain PyTorch versions of the prefill attention kernels — the math of
`repro.models.layers.prefill_attention_jnp` on tensors."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.ref import NEG_INF, paged_view


def prefill_attention_ref(q, k_cache, v_cache, start, window: int = 0):
    """Chunk GQA attention against a cache. q [B,C,H,hd]; caches
    [B,Hkv,S,hd] already holding the chunk's own K/V columns; `start` =
    global position of chunk token 0 (scalar or per-row [B]). Query c of
    row b attends positions <= start[b] + c (and > it minus `window`).
    Returns [B,C,H,hd] in q's dtype."""
    B, Hkv, S, hd = k_cache.shape
    C, H = q.shape[1], q.shape[2]
    G = H // Hkv
    dev = q.device
    qf = q.reshape(B, C, Hkv, G, hd)
    logits = torch.einsum("bchgd,bhsd->bchgs", qf, k_cache.to(qf.dtype))
    logits = logits.float() / math.sqrt(hd)
    qpos = torch.as_tensor(start, device=dev).reshape(-1, 1) \
        + torch.arange(C, device=dev)[None]                      # [B|1,C]
    pos = torch.arange(S, device=dev)
    valid = pos[None, None, :] <= qpos[..., None]                 # [B,C,S]
    if window:
        valid &= pos[None, None, :] > qpos[..., None] - window
    logits = logits.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bchgs,bhsd->bchgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(B, C, H, hd)


def paged_prefill_attention_ref(q, k_pool, v_pool, tables, start,
                                window: int = 0):
    """`prefill_attention_ref` over the dense view of a paged pool."""
    return prefill_attention_ref(q, paged_view(k_pool, tables),
                                 paged_view(v_pool, tables), start,
                                 window=window)
