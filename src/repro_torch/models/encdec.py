"""Encoder-decoder transformer (SeamlessM4T-style backbone)
[arXiv:2308.11596] — the port of `repro/models/encdec.py`. The speech
frontend (mel + conv feature extractor) is a stub, as in the JAX
package: `batch["frames"]` carries precomputed frame embeddings
[B, S_src, d_model]. The encoder is bidirectional; the decoder has
causal self-attention and cross-attention to the encoder output.

The parameters keep the JAX package's stacked leaves (`enc`, `dec`
`[L, ...]`) in one plain tree for training and serving alike. Training
attends through `chunked_attention` (plain ops, as the JAX package);
`forward` and `encode` recompute each layer in the backward pass when
`cfg.remat` is set. Decode runs both attentions through K7 on the card
(`layers.attention_decode_slots` for the self-attention, every row at
`index`; `layers.decode_attention_slots` over the whole source for the
cross-attention) and their plain versions on the CPU. `decode_step` and
`prefill_cross` update the cache IN PLACE and return it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.nn import resolve_device, stack_specs, tree_at


def src_len(cfg, tgt_len: int) -> int:
    return max(cfg.attn_chunk, tgt_len // 4)


# ------------------------------------------------------------- specs
def enc_block_specs(cfg) -> dict:
    return {
        "ln1": L.norm_specs(cfg.d_model, cfg.norm),
        "attn": L.attention_specs(cfg),
        "ln2": L.norm_specs(cfg.d_model, cfg.norm),
        "mlp": L.mlp_specs(cfg),
    }


def dec_block_specs(cfg) -> dict:
    return {
        "ln1": L.norm_specs(cfg.d_model, cfg.norm),
        "self_attn": L.attention_specs(cfg),
        "ln_x": L.norm_specs(cfg.d_model, cfg.norm),
        "cross_attn": L.attention_specs(cfg),
        "ln2": L.norm_specs(cfg.d_model, cfg.norm),
        "mlp": L.mlp_specs(cfg),
    }


def model_specs(cfg) -> dict:
    return {
        "embed": L.embed_specs(cfg.vocab_size, cfg.d_model),
        "enc": stack_specs(enc_block_specs(cfg), cfg.enc_layers),
        "dec": stack_specs(dec_block_specs(cfg), cfg.n_layers),
        "ln_enc": L.norm_specs(cfg.d_model, cfg.norm),
        "ln_f": L.norm_specs(cfg.d_model, cfg.norm),
    }


# ------------------------------------------------------------- cross-attn
def cross_attention(p, x, enc_kv, cfg) -> torch.Tensor:
    """x [B,Sq,d]; enc_kv = (k, v) [B,S_src,Hkv,hd] precomputed."""
    B, Sq, _ = x.shape
    q = L.linear(p["wq"], x).reshape(B, Sq, cfg.n_heads, cfg.hd)
    k, v = enc_kv
    out = L.chunked_attention(q, k, v, cfg, causal=False)
    return L.linear(p["wo"], out.reshape(B, Sq, cfg.n_heads * cfg.hd))


def enc_kv(p, enc_out, cfg) -> tuple:
    B, S, _ = enc_out.shape
    k = L.linear(p["wk"], enc_out).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = L.linear(p["wv"], enc_out).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return k, v


# ------------------------------------------------------------- forward
def _layers(body, x, stacked, n: int, cfg, *args) -> torch.Tensor:
    """x through the n stacked layers of `stacked`, each recomputed in
    the backward pass when `cfg.remat` is set and autograd records."""
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(n):
        lp = tree_at(stacked, l)
        x = (checkpoint(body, lp, x, cfg, *args, use_reentrant=False)
             if remat else body(lp, x, cfg, *args))
    return x


def _enc_block(lp, x, cfg, pos):
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    x = x + L.attention_train(lp["attn"], h, cfg, pos, causal=False)
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    return x + L.apply_mlp(lp["mlp"], h)


def _dec_block(lp, x, cfg, pos, enc_out, window):
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    x = x + L.attention_train(lp["self_attn"], h, cfg, pos, True, window)
    h = L.apply_norm(lp["ln_x"], x, cfg.norm)
    kv = enc_kv(lp["cross_attn"], enc_out, cfg)
    x = x + cross_attention(lp["cross_attn"], h, kv, cfg)
    h = L.apply_norm(lp["ln2"], x, cfg.norm)
    return x + L.apply_mlp(lp["mlp"], h)


def _positions(x) -> torch.Tensor:
    B, S, _ = x.shape
    return torch.arange(S, device=x.device)[None].expand(B, S)


def encode(params, frames, cfg) -> torch.Tensor:
    x = frames.to(cfg.dtype)
    x = _layers(_enc_block, x, params["enc"], cfg.enc_layers, cfg,
                _positions(x))
    return L.apply_norm(params["ln_enc"], x, cfg.norm)


def decode_tokens(params, tokens, enc_out, cfg,
                  window: int = 0) -> torch.Tensor:
    """The decoder over the target tokens, attending `enc_out`: logits
    [B, S, V] (the forward's second half; split learning runs it on the
    server)."""
    x = L.embed_lookup(params["embed"], tokens, cfg.dtype)
    x = _layers(_dec_block, x, params["dec"], cfg.n_layers, cfg,
                _positions(x), enc_out, window)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x)


def forward(params: dict, batch: dict, cfg, window: int = 0) -> tuple:
    enc_out = encode(params, batch["frames"], cfg)
    logits = decode_tokens(params, batch["tokens"], enc_out, cfg, window)
    return logits, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                            device=logits.device)}


# ------------------------------------------------------------- decode
def cache_shapes(cfg, batch: int, seq_len: int) -> dict:
    """The self-attention cache and the cross-attention K/V of every
    decoder layer. Unlike the JAX package (`xk` / `xv` [L, B, S_src,
    Hkv, hd]), the cross K/V are held [L, B, Hkv, S_src, hd], K7's
    layout, so that no decode step copies a transpose; `prefill_cross`
    writes them so."""
    hd = cfg.hd
    self_kv = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len, hd)
    cross = (cfg.n_layers, batch, cfg.n_kv_heads, src_len(cfg, seq_len), hd)
    ax = ("layers", "batch", "kv_heads", "kv_seq", None)
    return {"k": (self_kv, ax, cfg.dtype), "v": (self_kv, ax, cfg.dtype),
            "xk": (cross, ax, cfg.dtype), "xv": (cross, ax, cfg.dtype)}


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dtype, device=dev)
            for k, (shape, _, dtype) in
            cache_shapes(cfg, batch, seq_len).items()}


def prefill_cross(params, frames, cfg, cache: dict) -> dict:
    """Run the encoder once and fill the cross-attention K/V of every
    decoder layer (in place)."""
    enc_out = encode(params, frames, cfg)
    for l in range(cfg.n_layers):
        k, v = enc_kv(tree_at(params["dec"], l)["cross_attn"], enc_out, cfg)
        cache["xk"][l].copy_(k.transpose(1, 2))
        cache["xv"][l].copy_(v.transpose(1, 2))
    return cache


def decode_step(params, cache: dict, token: torch.Tensor, index, cfg,
                window: int = 0) -> tuple:
    """token [B,1] int at position `index` (a scalar, or a per-row [B]
    vector) -> (logits [B,1,V], cache) with the self-attention cache
    updated IN PLACE."""
    x = L.embed_lookup(params["embed"], token, cfg.dtype)
    B, hd = x.shape[0], cfg.hd
    indices = torch.as_tensor(index, device=x.device).to(
        torch.int32).expand(B)
    s_src = cache["xk"].shape[3]
    for l in range(cfg.n_layers):
        lp = tree_at(params["dec"], l)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        attn, _, _ = L.attention_decode_slots(
            lp["self_attn"], h, cfg, cache["k"][l], cache["v"][l], indices,
            window)
        x = x + attn
        h = L.apply_norm(lp["ln_x"], x, cfg.norm)
        q = L.linear(lp["cross_attn"]["wq"], h).reshape(B, cfg.n_heads, hd)
        out = L.decode_attention_slots(q, cache["xk"][l], cache["xv"][l],
                                       s_src)
        x = x + L.linear(lp["cross_attn"]["wo"],
                         out.reshape(B, 1, cfg.n_heads * hd).to(x.dtype))
        h = L.apply_norm(lp["ln2"], x, cfg.norm)
        x = x + L.apply_mlp(lp["mlp"], h)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x), cache
