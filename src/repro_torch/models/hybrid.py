"""Zamba2-style hybrid [arXiv:2411.15242] — the port of
`repro/models/hybrid.py`: a Mamba2 backbone with a single SHARED
attention + MLP block applied after every `attn_every` SSM blocks.

The parameters keep the JAX package's stacked leaves (`mamba` leaves
`[n_super, every, ...]`, `tail` leaves `[tail, ...]`) in one plain tree
for training and serving alike, so the FL packets (one per leaf) and
their bills are JAX's. The shared block has one parameter copy; each of
its applications has its own KV slot at decode (`attn_k` / `attn_v`
`[n_super, B, Hkv, S, hd]`). `forward` recomputes each super-block (and
each tail block) in the backward pass when `cfg.remat` is set
(`torch.utils.checkpoint`, as `jax.checkpoint`). `decode_step` updates
the cache IN PLACE and returns it; its shared attention writes and
reads through `layers.attention_decode_slots` with every row at
`index`: K7 on the card, the plain version on the CPU (the JAX package
computes the same function with `decode_attention_jnp`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (apply_mamba_block, apply_mamba_decode,
                                       mamba_cache_shapes, mamba_specs)
from repro_torch.nn import resolve_device, stack_specs, tree_at


def layout(cfg) -> tuple:
    """(n_super, SSM blocks a super-block, tail SSM blocks)."""
    every = cfg.attn_every or cfg.n_layers
    n_super = cfg.n_layers // every
    return n_super, every, cfg.n_layers - n_super * every


def model_specs(cfg) -> dict:
    n_super, every, tail = layout(cfg)
    s = {
        "embed": L.embed_specs(cfg.vocab_size, cfg.d_model),
        "mamba": stack_specs(stack_specs(mamba_specs(cfg), every, "inner"),
                             n_super),
        "shared_ln": L.norm_specs(cfg.d_model, cfg.norm),
        "shared_attn": L.attention_specs(cfg),
        "shared_ln2": L.norm_specs(cfg.d_model, cfg.norm),
        "shared_mlp": L.mlp_specs(cfg),
        "ln_f": L.norm_specs(cfg.d_model, cfg.norm),
    }
    if tail:
        s["tail"] = stack_specs(mamba_specs(cfg), tail)
    return s


def _shared_block(params, x, cfg, positions, window):
    h = L.apply_norm(params["shared_ln"], x, cfg.norm)
    x = x + L.attention_train(params["shared_attn"], h, cfg, positions,
                              True, window)
    h = L.apply_norm(params["shared_ln2"], x, cfg.norm)
    return x + L.apply_mlp(params["shared_mlp"], h)


def _super_block(params, x, mstack, cfg, positions, window):
    for i in range(layout(cfg)[1]):
        x = apply_mamba_block(tree_at(mstack, i), x, cfg)
    return _shared_block(params, x, cfg, positions, window)


def run_superblocks(params, x, cfg, lo: int, hi: int,
                    window: int = 0) -> torch.Tensor:
    """x through super-blocks [lo, hi), then the tail blocks when
    hi >= n_super (the JAX package's split rule), each recomputed in the
    backward pass when `cfg.remat` is set and autograd records."""
    n_super, _, tail = layout(cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    for s in range(lo, hi):
        mstack = tree_at(params["mamba"], s)
        if remat:
            x = checkpoint(_super_block, params, x, mstack, cfg, positions,
                           window, use_reentrant=False)
        else:
            x = _super_block(params, x, mstack, cfg, positions, window)
    if tail and hi >= n_super:
        for i in range(tail):
            tp = tree_at(params["tail"], i)
            x = (checkpoint(apply_mamba_block, tp, x, cfg,
                            use_reentrant=False) if remat
                 else apply_mamba_block(tp, x, cfg))
    return x


def forward(params: dict, batch: dict, cfg, window: int = 0) -> tuple:
    x = L.embed_lookup(params["embed"], batch["tokens"], cfg.dtype)
    x = run_superblocks(params, x, cfg, 0, layout(cfg)[0], window)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x), {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


# ------------------------------------------------------------- decode
def cache_shapes(cfg, batch: int, seq_len: int) -> dict:
    n_super, every, tail = layout(cfg)
    m = mamba_cache_shapes(cfg, n_super * every + tail, batch)
    kv = (n_super, batch, cfg.n_kv_heads, seq_len, cfg.hd)
    ax = ("layers", "batch", "kv_heads", "kv_seq", None)
    m["attn_k"] = (kv, ax, cfg.dtype)
    m["attn_v"] = (kv, ax, cfg.dtype)
    return m


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dtype, device=dev)
            for k, (shape, _, dtype) in
            cache_shapes(cfg, batch, seq_len).items()}


def _shared_decode(params, x, cfg, cache_k, cache_v, indices, window,
                   kept=None):
    """The shared block at one token: its KV slot written in place (the
    `kept` writes only, when given)."""
    h = L.apply_norm(params["shared_ln"], x, cfg.norm)
    attn, _, _ = L.attention_decode_slots(params["shared_attn"], h, cfg,
                                          cache_k, cache_v, indices, window,
                                          kept=kept)
    x = x + attn
    h = L.apply_norm(params["shared_ln2"], x, cfg.norm)
    return x + L.apply_mlp(params["shared_mlp"], h)


def decode_step(params, cache: dict, token: torch.Tensor, index, cfg,
                window: int = 0, active=None) -> tuple:
    """token [B,1] int at position `index` (a scalar, or a per-row [B]
    vector) -> (logits [B,1,V], cache) with the cache updated IN
    PLACE. `active` [B] bool keeps the inactive rows' states and KV
    columns (runtime/serve_step.py's scan prefill masks its padded
    tail so, as the JAX scan masks each cache row)."""
    x = L.embed_lookup(params["embed"], token, cfg.dtype)
    B = x.shape[0]
    indices = torch.as_tensor(index, device=x.device).to(
        torch.int32).expand(B)
    n_super, every, tail = layout(cfg)
    ssm, conv = cache["ssm"], cache["conv"]

    kept = L.kept_writes(active[:, None]) if active is not None else None

    def put(leaf, new):
        if active is not None:
            new = torch.where(active.reshape((B,) + (1,) * (new.ndim - 1)),
                              new, leaf)
        leaf.copy_(new)

    def mamba(mp, x, l):
        x, s, c = apply_mamba_decode(mp, x, cfg, ssm[l], conv[l])
        put(ssm[l], s)
        put(conv[l], c)
        return x

    for s in range(n_super):
        mstack = tree_at(params["mamba"], s)
        for i in range(every):
            x = mamba(tree_at(mstack, i), x, s * every + i)
        x = _shared_decode(params, x, cfg, cache["attn_k"][s],
                           cache["attn_v"][s], indices, window, kept)
    for i in range(tail):
        x = mamba(tree_at(params["tail"], i), x, n_super * every + i)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x), cache
