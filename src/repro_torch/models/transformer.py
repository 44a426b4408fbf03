"""Decoder-only transformer LM, dense, MoE and VLM families — the port of
`repro/models/transformer.py` (teacher-forced forward, per-slot decode,
fused chunk prefill; dense and paged KV caches). A MoE block holds
`moe` (models/moe.py) where a dense block holds `mlp`; its load-balance
loss is summed over the layers of `forward` and divided by n_layers,
and decode and prefill drop it, as the JAX package does. A VLM config
(`frontend="vision"`) has `vis_proj`, which projects a batch's
precomputed `patch_embeds` (the vision tower is a stub, as in the JAX
package) and puts them before the tokens in `embed_inputs`. Serving runs
on tokens only, as the JAX engine does (its serve steps never pass
`patch_embeds`), so `vis_proj` is unused by `decode_step` and
`prefill_step`.

Two parameter layouts. Serving (`model_specs`, `init_params`) holds the
layers as a list of per-layer subtrees. Training (`train_specs`,
`init_tree`) holds them as the JAX package's stacked `[L, ...]` leaves,
so the trainable tree has JAX's leaves (14 for qwen1.5-0.5b): the wire
bills and quantizes one packet per leaf, and the optimizer state has the
same layout. `forward` takes either; it unbinds the stacked leaves into
per-layer views (one `stack` per leaf in the backward pass) and walks
the layers in a Python loop, each through `torch.utils.checkpoint` when
`cfg.remat` is set. The caches keep the stacked `[L, ...]` layout and
are updated IN PLACE: `decode_step` and `prefill_step` write the new K/V
columns into the tensors they are given and return those same tensors.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.nn import (resolve_device, stack_specs, tree_leaves,
                            tree_unflatten)


# ------------------------------------------------------------- specs
def block_specs(cfg) -> dict:
    s = {
        "ln_attn": L.norm_specs(cfg.d_model, cfg.norm),
        "attn": L.attention_specs(cfg),
    }
    if not cfg.parallel_block:
        s["ln_mlp"] = L.norm_specs(cfg.d_model, cfg.norm)
    if cfg.is_moe:
        s["moe"] = moe_specs(cfg)
    else:
        s["mlp"] = L.mlp_specs(cfg)
    return s


def _frontend_specs(cfg) -> dict:
    """The VLM's projector from the (stub) vision tower's hidden size to
    d_model, as the JAX package declares it."""
    if cfg.frontend == "vision":
        return {"vis_proj": L.linear_specs(cfg.d_model, cfg.d_model,
                                           ("embed", "act_embed"))}
    return {}


def model_specs(cfg) -> dict:
    """The serving layout: `layers` a list of per-layer subtrees."""
    return {
        "embed": L.embed_specs(cfg.vocab_size, cfg.d_model),
        "layers": [block_specs(cfg) for _ in range(cfg.n_layers)],
        "ln_f": L.norm_specs(cfg.d_model, cfg.norm),
        **_frontend_specs(cfg),
    }


def train_specs(cfg) -> dict:
    """The training layout, the JAX package's `model_specs`: every layer
    leaf stacked to `[L, ...]` with a leading "layers" axis."""
    return {
        "embed": L.embed_specs(cfg.vocab_size, cfg.d_model),
        "layers": stack_specs(block_specs(cfg), cfg.n_layers),
        "ln_f": L.norm_specs(cfg.d_model, cfg.norm),
        **_frontend_specs(cfg),
    }


def layer_list(layers) -> list:
    """Per-layer parameter subtrees: the serving list as it is, or the
    training tree's stacked leaves unbound into per-layer views."""
    if not isinstance(layers, dict):
        return list(layers)
    cols = [leaf.unbind(0) for leaf in tree_leaves(layers)]
    return [tree_unflatten(layers, [c[l] for c in cols])
            for l in range(len(cols[0]))]


# ------------------------------------------------------------- blocks
def _ffn(lp, h, cfg) -> tuple:
    """The block's feed-forward on h: (out, load-balance loss or None)."""
    if cfg.is_moe:
        m, a = apply_moe(lp["moe"], h, cfg)
        return m, a["lb_loss"]
    return L.apply_mlp(lp["mlp"], h), None


def _ffn_residual(lp, x, h, attn, cfg) -> tuple:
    """x + attn + ffn (parallel block: ffn of h; serial: of the re-normed
    x + attn). Returns (x, load-balance loss or None)."""
    if cfg.parallel_block:
        m, lb = _ffn(lp, h, cfg)
        return x + attn + m, lb
    x = x + attn
    m, lb = _ffn(lp, L.apply_norm(lp["ln_mlp"], x, cfg.norm), cfg)
    return x + m, lb


def apply_block(lp, x, cfg, positions=None, causal=True, window: int = 0):
    """Returns (x, aux_loss): the block's load-balance loss (MoE), else
    0, in float32."""
    h = L.apply_norm(lp["ln_attn"], x, cfg.norm)
    attn = L.attention_train(lp["attn"], h, cfg, positions, causal, window)
    x, lb = _ffn_residual(lp, x, h, attn, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux if lb is None else aux + lb


def apply_block_decode(lp, x, cfg, ck, cv, index, window=0, pages=None,
                       kept=None):
    h = L.apply_norm(lp["ln_attn"], x, cfg.norm)
    attn, ck, cv = L.attention_decode_slots(lp["attn"], h, cfg, ck, cv,
                                            index, window, pages, kept)
    return _ffn_residual(lp, x, h, attn, cfg)[0], ck, cv


def apply_block_prefill(lp, x, cfg, ck, cv, start, n_valid, window=0,
                        pages=None, kept=None):
    h = L.apply_norm(lp["ln_attn"], x, cfg.norm)
    attn, ck, cv = L.attention_prefill_slots(lp["attn"], h, cfg, ck, cv,
                                             start, n_valid, window, pages,
                                             kept)
    return _ffn_residual(lp, x, h, attn, cfg)[0], ck, cv


# ------------------------------------------------------------- forward
def embed_inputs(params, batch: dict, cfg) -> torch.Tensor:
    """tokens (+ `patch_embeds` [B, P, d] for a vision config) -> [B, P +
    S, d] activations: the projected patches first, then the tokens."""
    x = L.embed_lookup(params["embed"], batch["tokens"], cfg.dtype)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        vis = L.linear(params["vis_proj"],
                       batch["patch_embeds"].to(cfg.dtype))
        x = torch.cat([vis, x], dim=1)
    return x


def apply_blocks(layers: list, x, cfg, positions, window: int = 0,
                 aux=None) -> tuple:
    """x through the given per-layer subtrees in order, each block
    recomputed in the backward pass when `cfg.remat` is set. Returns
    (x, aux): `aux` (0 by default) plus each block's load-balance loss,
    added layer by layer as the JAX package's scan carries it."""
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layers:
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(apply_block, lp, x, cfg, positions, True,
                              window, use_reentrant=False)
        else:
            x, a = apply_block(lp, x, cfg, positions, True, window)
        aux = aux + a
    return x, aux


def forward(params, batch: dict, cfg, window: int = 0) -> tuple:
    """Full-sequence teacher-forced forward, either parameter layout.
    Returns (logits, aux) with aux_loss summed over layers / n_layers."""
    x = embed_inputs(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, aux = apply_blocks(layer_list(params["layers"]), x, cfg, positions,
                          window)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x), {"aux_loss": aux / cfg.n_layers}


# ------------------------------------------------------------- caches
def init_cache_shapes(cfg, batch_size: int, seq_len: int):
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, seq_len, cfg.hd)
    axes = ("layers", "batch", "kv_heads", "kv_seq", None)
    return {"k": (shape, axes, cfg.dtype), "v": (shape, axes, cfg.dtype)}


def init_cache(cfg, batch_size: int, seq_len: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, (shape, axes, dtype) in
            init_cache_shapes(cfg, batch_size, seq_len).items()}


def paged_cache_shapes(cfg, n_pages: int, page_size: int):
    """Paged KV layout: fixed-size pages from one shared pool — no batch
    axis; slots map logical columns onto pool pages via per-slot page
    tables (serve/paging.py owns allocation)."""
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.hd)
    axes = ("layers", None, "kv_heads", None, None)
    return {"k": (shape, axes, cfg.dtype), "v": (shape, axes, cfg.dtype)}


def init_paged_cache(cfg, n_pages: int, page_size: int,
                     device="cuda") -> dict:
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, (shape, axes, dtype) in
            paged_cache_shapes(cfg, n_pages, page_size).items()}


# ------------------------------------------------------------- steps
def decode_step(params, cache: dict, token: torch.Tensor,
                index: torch.Tensor, cfg, window: int = 0, pages=None,
                active=None) -> tuple:
    """token [B,1] int; index a per-slot [B] vector of write positions.
    Returns (logits [B,1,V], cache) with the cache updated in place.

    With `pages` = {"tables": [B,n_lp], "page_size": int, "active": [B]
    bool or None} the cache leaves are the shared page pool from
    `init_paged_cache`. `active` [B] bool (dense) or `pages["active"]`
    (paged) selects the rows whose K/V write lands; the JAX package gets
    the same effect for the dense cache by a batch select afterwards."""
    B = token.shape[0]
    index = index.reshape(B)
    if pages is not None and pages.get("active") is not None:
        active = pages["active"]
    kept = L.kept_writes(active[:, None]) if active is not None \
        else L._all_writes(B, 1, token.device)
    x = L.embed_lookup(params["embed"], token, cfg.dtype)
    for l, lp in enumerate(params["layers"]):
        x, _, _ = apply_block_decode(lp, x, cfg, cache["k"][l],
                                     cache["v"][l], index, window, pages,
                                     kept)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x), cache


def prefill_step(params, cache: dict, tokens: torch.Tensor,
                 start: torch.Tensor, n_valid: torch.Tensor, cfg,
                 window: int = 0, pages=None) -> tuple:
    """Fused chunk prefill: tokens [B,C] — one prompt chunk per slot,
    row b's chunk starting at cache position start[b] with n_valid[b]
    real tokens (the rest padded tail, not written; a row with n_valid=0
    is untouched). Returns (last_logits [B,V] fp32 — the logits of each
    row's last valid chunk token — and the cache, updated in place)."""
    B, C = tokens.shape
    keep = torch.arange(C, device=tokens.device)[None, :] < n_valid[:, None]
    if pages is not None and pages.get("active") is not None:
        keep &= pages["active"][:, None]
    kept = L.kept_writes(keep)
    x = L.embed_lookup(params["embed"], tokens, cfg.dtype)
    for l, lp in enumerate(params["layers"]):
        x, _, _ = apply_block_prefill(lp, x, cfg, cache["k"][l],
                                      cache["v"][l], start, n_valid, window,
                                      pages, kept)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    last = (n_valid.long() - 1).clamp(0, C - 1)
    xl = x[torch.arange(B, device=x.device), last][:, None]      # [B,1,d]
    return L.unembed(params["embed"], xl)[:, 0].float(), cache
