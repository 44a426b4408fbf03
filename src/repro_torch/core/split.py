"""Split learning (paper Alg. 2) — the port of `repro/core/split.py`:
the model is cut at `wcfg.split_layer` (the tiny model after conv+pool);
the user-side activation is semantically compressed (x4), crosses the
wireless channel (forward AND backward — the gradient is tau-clipped and
re-quantized on the way down, Alg. 2 lines 11-17), and the server side
finishes the pass. The cut is a layer for the dense, MoE and VLM
families, a super-block for xLSTM and hybrid stacks, and the
encoder/decoder boundary for the enc-dec family (the encoder output is
the smashed data)."""
from __future__ import annotations

import torch

from repro_torch.core import semantic
from repro_torch.core.channel import channel_crossing
from repro_torch.models import layers as L
from repro_torch.models import encdec, hybrid, lstm_tiny, transformer, xlstm
from repro_torch.nn import init_tree


def codec_specs(cfg, wcfg) -> dict:
    d = lstm_tiny.CONV_F if cfg.family == "tiny" else cfg.d_model
    return semantic.codec_specs(d, wcfg.compress_factor)


def init_codec(generator, cfg, wcfg, device="cuda") -> dict:
    return init_tree(codec_specs(cfg, wcfg), generator, device)


def _link(codec, x, wcfg, key):
    z = semantic.encode(codec, x)
    z = channel_crossing(z, key, wcfg.quant_bits, wcfg.snr_db, wcfg.fading,
                         wcfg.grad_clip, wcfg.perfect_channel,
                         wcfg.arq_attempts, wcfg.arq_min_f2, wcfg.arq_max_tx,
                         wcfg.ge_p_gb, wcfg.ge_p_bg)
    return semantic.decode(codec, z)


def _split_transformer(params, codec, batch, cfg, wcfg, key, window):
    """Layers [0, cut) on the user, the link, layers [cut, L) on the
    server, with cut = min(split_layer, n_layers - 1); a MoE stack's
    load-balance loss adds up across the cut."""
    x = transformer.embed_inputs(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    layers = transformer.layer_list(params["layers"])
    cut = min(wcfg.split_layer, cfg.n_layers - 1)
    x, aux = transformer.apply_blocks(layers[:cut], x, cfg, positions,
                                      window)
    x = _link(codec, x, wcfg, key)
    x, aux = transformer.apply_blocks(layers[cut:], x, cfg, positions,
                                      window, aux)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x), {"aux_loss": aux / cfg.n_layers}


def _split_outer_scan(params, codec, batch, cfg, wcfg, key, window):
    """xLSTM / hybrid: super-blocks [0, cut) on the user, the link,
    [cut, n_super) on the server, cut = max(1, min(split_layer,
    n_super - 1)) counted in super-blocks (the stacked outer dim), not
    layers. A hybrid's tail blocks run after super-block n_super - 1,
    on whichever side runs it."""
    if cfg.family == "ssm":
        n_outer = xlstm.super_block_layout(cfg)[0]

        def run(x, lo, hi):
            return xlstm.run_superblocks(params, x, cfg, lo, hi)
    else:
        n_outer = hybrid.layout(cfg)[0]

        def run(x, lo, hi):
            return hybrid.run_superblocks(params, x, cfg, lo, hi, window)
    cut = max(1, min(wcfg.split_layer, n_outer - 1))
    x = L.embed_lookup(params["embed"], batch["tokens"], cfg.dtype)
    x = run(x, 0, cut)
    x = _link(codec, x, wcfg, key)
    x = run(x, cut, n_outer)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x), {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


def _split_encdec(params, codec, batch, cfg, wcfg, key, window):
    """Enc-dec: the encoder output IS the smashed data (the canonical SL
    cut; for seamless the user device runs the speech encoder)."""
    enc_out = encdec.encode(params, batch["frames"], cfg)
    enc_out = _link(codec, enc_out, wcfg, key)
    logits = encdec.decode_tokens(params, batch["tokens"], enc_out, cfg,
                                  window)
    return logits, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                            device=logits.device)}


def _split_tiny(params, codec, batch, cfg, wcfg, key):
    smashed = lstm_tiny.user_forward(params, batch["tokens"])
    smashed = _link(codec, smashed, wcfg, key)
    logits = lstm_tiny.server_forward(params, smashed)
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


def crossing_elems(cfg, shape_cfg, wcfg) -> int:
    """Element count of ONE link leg (the encoded smashed activation) of
    one full-batch train step: B x S' x (d / compress_factor), S' the
    family's sequence length at the cut (pooled for the tiny model,
    frontend-extended for VLM, the encoder grid for enc-dec)."""
    d = lstm_tiny.CONV_F if cfg.family == "tiny" else cfg.d_model
    c = max(1, d // wcfg.compress_factor)
    if cfg.family == "tiny":
        s = (lstm_tiny.SEQ - lstm_tiny.CONV_K + 1) // 2
    elif cfg.family == "audio":
        s = encdec.src_len(cfg, shape_cfg.seq_len)
    elif cfg.frontend == "vision":
        s = shape_cfg.seq_len + cfg.n_frontend_tokens
    else:
        s = shape_cfg.seq_len
    return shape_cfg.global_batch * s * c


def split_forward(params, codec, batch, cfg, wcfg, key, window: int = 0):
    if cfg.family in ("dense", "moe", "vlm"):
        return _split_transformer(params, codec, batch, cfg, wcfg, key,
                                  window)
    if cfg.family in ("ssm", "hybrid"):
        return _split_outer_scan(params, codec, batch, cfg, wcfg, key,
                                 window)
    if cfg.family == "audio":
        return _split_encdec(params, codec, batch, cfg, wcfg, key, window)
    if cfg.family == "tiny":
        return _split_tiny(params, codec, batch, cfg, wcfg, key)
    raise ValueError(f"split learning: unknown family {cfg.family!r}")
