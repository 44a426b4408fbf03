"""Split learning (paper Alg. 2) — the port of `repro/core/split.py`,
tiny family only: the model is cut after conv+pool; the user-side
activation is semantically compressed (x4), crosses the wireless
channel (forward AND backward — the gradient is tau-clipped and
re-quantized on the way down, Alg. 2 lines 11-17), and the server side
finishes the pass. The other families' cuts are still to port
(ROADMAP.md)."""
from __future__ import annotations

import torch

from repro_torch.core import semantic
from repro_torch.core.channel import channel_crossing
from repro_torch.models import lstm_tiny
from repro_torch.nn import init_tree


def _tiny_only(cfg) -> None:
    if cfg.family != "tiny":
        raise NotImplementedError(
            f"split learning for family {cfg.family!r} is not ported yet; "
            f"the port splits the tiny family only (see ROADMAP.md, P15)")


def codec_specs(cfg, wcfg) -> dict:
    _tiny_only(cfg)
    return semantic.codec_specs(lstm_tiny.CONV_F, wcfg.compress_factor)


def init_codec(generator, cfg, wcfg, device="cuda") -> dict:
    return init_tree(codec_specs(cfg, wcfg), generator, device)


def _link(codec, x, wcfg, key):
    z = semantic.encode(codec, x)
    z = channel_crossing(z, key, wcfg.quant_bits, wcfg.snr_db, wcfg.fading,
                         wcfg.grad_clip, wcfg.perfect_channel,
                         wcfg.arq_attempts, wcfg.arq_min_f2, wcfg.arq_max_tx,
                         wcfg.ge_p_gb, wcfg.ge_p_bg)
    return semantic.decode(codec, z)


def _split_tiny(params, codec, batch, cfg, wcfg, key):
    smashed = lstm_tiny.user_forward(params, batch["tokens"])
    smashed = _link(codec, smashed, wcfg, key)
    logits = lstm_tiny.server_forward(params, smashed)
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


def crossing_elems(cfg, shape_cfg, wcfg) -> int:
    """Element count of ONE link leg of one full-batch train step:
    B x T_pool x (d / compress_factor)."""
    _tiny_only(cfg)
    c = max(1, lstm_tiny.CONV_F // wcfg.compress_factor)
    s = (lstm_tiny.SEQ - lstm_tiny.CONV_K + 1) // 2
    return shape_cfg.global_batch * s * c


def split_forward(params, codec, batch, cfg, wcfg, key, window: int = 0):
    _tiny_only(cfg)
    return _split_tiny(params, codec, batch, cfg, wcfg, key)
