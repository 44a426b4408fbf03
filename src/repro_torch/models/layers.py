"""Shared layer library — the port of `repro/models/layers.py`: norms,
RoPE, GQA attention (teacher-forced through `chunked_attention`, cached
decode, chunk prefill; dense or paged KV), gated MLP, embeddings.
Pure functions over `ParamDict` parameters.

Attention on the serving path goes through the kernel wrappers
(`kernels/*/ops.py`): a CUDA tensor launches the hand-written kernel, a
CPU tensor runs its plain version. There is no third route and no
environment switch.

KV writes are in place. JAX drops masked writes by routing them out of
bounds (`mode="drop"`); torch's `index_put_` has no such mode, so the
writes that land are selected explicitly: a `kept` pair (rows, chunk
positions) of index tensors, computed once per step by the caller (one
host sync per step, not one per layer) or derived here from the mask.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import (NEG_INF,
                                                      decode_attention_ref,
                                                      paged_view)
from repro_torch.kernels.prefill_attention import ops as prefill_ops
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref
from repro_torch.nn import Spec
from repro_torch.nn.sharding import refuse_model_split

# the plain attention math and `paged_view` live beside the kernels
# (kernels/*/ref.py); the JAX package's names are kept here so that
# repro.models.layers and this module expose the same functions
decode_attention_jnp = decode_attention_ref
prefill_attention_jnp = prefill_attention_ref


# ---------------------------------------------------------------- norms
def norm_specs(d: int, kind: str = "rmsnorm") -> dict:
    s = {"scale": Spec((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        s["bias"] = Spec((d,), ("embed",), init="zeros")
    return s


def apply_norm(p, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- embeddings
def embed_specs(vocab: int, d: int) -> dict:
    return {"table": Spec((vocab, d), ("vocab", "embed"), init="embed",
                          scale=0.02)}


def embed_lookup(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather then cast == cast then gather, without casting the table
    return p["table"][tokens.long()].to(dtype)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits against the embedding table cast to the
    activation dtype."""
    return x @ p["table"].to(x.dtype).T


# ---------------------------------------------------------------- linear
def linear_specs(d_in: int, d_out: int, axes=("embed", "mlp"),
                 bias: bool = False, scale: float = 1.0) -> dict:
    s = {"w": Spec((d_in, d_out), axes, init="fan_in", scale=scale)}
    if bias:
        s["b"] = Spec((d_out,), (axes[1],), init="zeros")
    return s


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------- RoPE
@functools.lru_cache(maxsize=None)
def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    """The rotary frequencies, computed on the host in float32 (bit for
    bit the JAX package's on the CPU) and kept on `device`. The card's
    pow differs from the host's in the last place for some of them,
    which moves an angle near position 30,000 by an ulp of the angle, up
    to 1.2e-4 in its sine (an H100, positions 0-32,767, hd 64)."""
    with torch.inference_mode(False):      # a tensor autograd may meet
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                                / dim)
        return freqs.to(device)


def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions [...,S] -> (sin, cos) each [...,S,dim/2] fp32."""
    ang = positions.float()[..., None] * _rope_freqs(dim, float(theta),
                                                     positions.device)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin, cos, fraction: float = 1.0):
    """x [B,S,H,hd]; rotate the first `fraction` of the head dim
    (interleaved pairs, as the JAX package does)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2].float(), xr[..., 1::2].float()
    sin = sin[..., : rot // 2][:, :, None, :].float()
    cos = cos[..., : rot // 2][:, :, None, :].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# ---------------------------------------------------------------- attention
def attention_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": linear_specs(d, cfg.n_heads * hd, ("embed", "qkv"), bias=cfg.qkv_bias),
        "wk": linear_specs(d, cfg.n_kv_heads * hd, ("embed", "qkv"), bias=cfg.qkv_bias),
        "wv": linear_specs(d, cfg.n_kv_heads * hd, ("embed", "qkv"), bias=cfg.qkv_bias),
        "wo": linear_specs(cfg.n_heads * hd, d, ("qkv", "embed")),
    }


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.hd
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_theta:
        sin, cos = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos, cfg.rope_fraction)
        k = apply_rope(k, sin, cos, cfg.rope_fraction)
    return q, k, v


def chunked_attention(q, k, v, cfg, causal: bool = True, window: int = 0,
                      kv_offset: int = 0) -> torch.Tensor:
    """Memory-bounded GQA attention with an online softmax, q [B,Sq,H,hd],
    k/v [B,Skv,Hkv,hd]: the JAX package's blocks in its order — query
    chunks outer, key chunks inner, running (max, sum, acc) in float32 —
    so scores never exceed [B,H,cq,ck]. Both lengths are padded to chunk
    multiples; padded keys are masked, padded queries sliced off. Plain
    PyTorch: the JAX package computes this outside any Pallas kernel."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    G = H // k.shape[2]
    cq = min(cfg.attn_chunk, Sq)
    ck = min(cfg.attn_chunk, Skv)
    pq, pk = (-Sq) % cq, (-Skv) % ck
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for i in range(0, Sq + pq, cq):
        qb = q[:, i:i + cq]
        qp = kv_offset + torch.arange(i, i + cq, device=dev)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        s = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32, device=dev)
        for j in range(0, Skv + pk, ck):
            kbg = k[:, j:j + ck].repeat_interleave(G, dim=2)
            vbg = v[:, j:j + ck].repeat_interleave(G, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", qb, kbg) * scale
            kp = torch.arange(j, j + ck, device=dev)
            mask = (kp < Skv)[None, :].expand(cq, ck)
            if causal:
                mask = mask & (qp[:, None] >= kp[None, :])
            if window:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            logits = torch.where(mask, logits.float(), NEG_INF)
            bm = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - bm[..., None])
            corr = torch.exp(m - bm)
            s = s * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qb.dtype), vbg).float()
            m = bm
        out = acc / torch.clamp(s[..., None], min=1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))      # [B,cq,H,hd]
    return torch.cat(outs, dim=1)[:, :Sq]


def attention_train(p, x, cfg, positions=None, causal=True, window=0):
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, cfg, causal=causal, window=window)
    return linear(p["wo"], out.reshape(B, S, cfg.n_heads * cfg.hd))


# ---------------------------------------------------------------- KV writes
def kept_writes(keep: torch.Tensor) -> tuple:
    """bool [B, C] write mask -> (rows, chunk positions) of the writes
    that land. One host sync; compute it once per step."""
    return keep.nonzero(as_tuple=True)


def _all_writes(B: int, C: int, device) -> tuple:
    rows = torch.arange(B, device=device).repeat_interleave(C)
    return rows, torch.arange(C, device=device).repeat(B)


def dense_insert(cache, cols, vals, kept):
    """In place: cache [B, Hkv, S, hd] gets vals [B, C, Hkv, hd] at each
    row's columns `cols` [B, C], for the (row, chunk position) pairs in
    `kept` only. Returns the cache."""
    rows, cpos = kept
    cache[rows, :, cols[rows, cpos].long()] = vals[rows, cpos].to(cache.dtype)
    return cache


def paged_insert(pool, tables, cols, vals, kept):
    """In place: scatter vals [B, C, Hkv, hd] into the shared pool
    [n_pages, Hkv, page, hd] at each slot's logical columns `cols`
    [B, C] through its page table, for the (row, chunk position) pairs
    in `kept` only — the pool has no batch axis, so masking inactive
    slots and padded chunk tails happens here at the write. Returns the
    pool."""
    rows, cpos = kept
    page = pool.shape[2]
    c = cols[rows, cpos].long()
    phys = tables.long()[rows, c // page]
    pool[phys, :, c % page] = vals[rows, cpos].to(pool.dtype)
    return pool


def _kept_for(pages, kept, B, C, device):
    if kept is not None:
        return kept
    if pages is not None and pages.get("active") is not None:
        return kept_writes(pages["active"][:, None].expand(B, C))
    return _all_writes(B, C, device)


# ---------------------------------------------------------------- serving
def decode_attention_slots(q, k_cache, v_cache, lengths, window: int = 0):
    """Per-slot flash-decode: q [B,H,hd], caches [B,Hkv,S,hd], `lengths`
    [B] — each row attends its OWN prefix (the engine's hot path)."""
    return decode_ops.gqa_decode(q, k_cache, v_cache, lengths,
                                 window=window).to(q.dtype)


def decode_attention_slots_paged(q, k_pool, v_pool, tables, lengths,
                                 window: int = 0):
    """Per-slot flash-decode over the shared page pool: q [B,H,hd], pools
    [n_pages,Hkv,page,hd], `tables` [B,n_lp], `lengths` [B]."""
    return decode_ops.gqa_decode_paged(q, k_pool, v_pool, tables, lengths,
                                       window=window).to(q.dtype)


def attention_decode_slots(p, x, cfg, cache_k, cache_v, indices, window=0,
                           pages=None, kept=None):
    """Slot-axis decode: x [B,1,d], `indices` [B] — each row writes its
    k/v at its own cache position (in place) and attends its own prefix.
    With `pages` = {"tables", "page_size", "active"} the caches are the
    shared page pool. `kept` selects the rows whose write lands (default:
    the active rows, or every row). Returns (out [B,1,d], k, v). Under a
    mesh whose `model` axis spans more than one device (where the JAX
    package may shard the cache along the sequence) it raises."""
    refuse_model_split("decode attention")
    B = x.shape[0]
    positions = indices[:, None]                           # [B,1]
    q, k, v = _qkv(p, x, cfg, positions)
    kept = _kept_for(pages, kept, B, 1, x.device)
    if pages is not None:
        paged_insert(cache_k, pages["tables"], positions, k, kept)
        paged_insert(cache_v, pages["tables"], positions, v, kept)
        out = decode_attention_slots_paged(q[:, 0], cache_k, cache_v,
                                           pages["tables"], indices + 1,
                                           window)
    else:
        dense_insert(cache_k, positions, k, kept)
        dense_insert(cache_v, positions, v, kept)
        out = decode_attention_slots(q[:, 0], cache_k, cache_v,
                                     indices + 1, window)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd).to(x.dtype)
    return linear(p["wo"], out), cache_k, cache_v


def attention_prefill_slots(p, x, cfg, cache_k, cache_v, start, n_valid,
                            window=0, pages=None, kept=None):
    """Fused chunk prefill: x [B,C,d] — C prompt tokens per slot starting
    at per-row cache position `start` [B]; chunk positions >= n_valid[b]
    are padded tail and are not written. One bulk K/V column write (in
    place) + one chunk-vs-cache attention launch. Returns
    (out [B,C,d], k, v)."""
    B, C, _ = x.shape
    ar = torch.arange(C, device=x.device)
    positions = start[:, None] + ar[None]                    # [B, C]
    q, k, v = _qkv(p, x, cfg, positions)
    if kept is None:
        keep = ar[None, :] < n_valid[:, None]
        if pages is not None and pages.get("active") is not None:
            keep &= pages["active"][:, None]
        kept = kept_writes(keep)
    if pages is not None:
        paged_insert(cache_k, pages["tables"], positions, k, kept)
        paged_insert(cache_v, pages["tables"], positions, v, kept)
        out = prefill_ops.gqa_prefill_paged(q, cache_k, cache_v,
                                            pages["tables"], start,
                                            window=window)
    else:
        dense_insert(cache_k, positions, k, kept)
        dense_insert(cache_v, positions, v, kept)
        out = prefill_ops.gqa_prefill(q, cache_k, cache_v, start,
                                      window=window)
    out = out.reshape(B, C, cfg.n_heads * cfg.hd).to(x.dtype)
    return linear(p["wo"], out), cache_k, cache_v


# ---------------------------------------------------------------- MLP
def mlp_specs(cfg, d_ff: int = 0) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": linear_specs(d, ff, ("embed", "mlp")),
        "wg": linear_specs(d, ff, ("embed", "mlp")),
        "wo": linear_specs(ff, d, ("mlp", "embed")),
    }


def apply_mlp(p, x):
    h = F.silu(linear(p["wg"], x)) * linear(p["wi"], x)
    return linear(p["wo"], h)
