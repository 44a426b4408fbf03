"""Unified model API: dispatch by family, input specs per shape, losses —
the port of `repro/models/api.py`. Every family of the JAX package is
ported: `dense`, `moe` and `vlm` (one transformer: `moe` with expert
blocks, `vlm` with projected patch embeddings before the tokens), the
recurrent `ssm` (xLSTM) and `hybrid` (Mamba2 + a shared attention
block) decoders and the `audio` encoder-decoder (stub frame embeddings
in, `input_specs` gives them), which have no fused prefill and are
served by the billed static loop of launch/serve.py, and the paper's
`tiny` classifier (a streaming decoder with no fused prefill, so
serving prefills it by the exact scan). `param_axes` and `input_axes`
name the logical axes of the trainable parameters and of a step's
inputs, which nn/sharding.py resolves against a mesh."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models import encdec, hybrid, lstm_tiny, transformer, xlstm
from repro_torch.nn import axes_tree


@dataclasses.dataclass(frozen=True)
class ModelApi:
    specs: Callable
    forward: Callable
    cache_shapes: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    prefill_step: Optional[Callable] = None
    # the trainable layout (the JAX package's param tree); `specs` is
    # the serving layout
    train_specs: Optional[Callable] = None


_TRANSFORMER = ModelApi(transformer.model_specs, transformer.forward,
                        transformer.init_cache_shapes,
                        transformer.init_cache, transformer.decode_step,
                        transformer.prefill_step, transformer.train_specs)
_FAMILIES = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "vlm": _TRANSFORMER,
    "ssm": ModelApi(xlstm.model_specs, xlstm.forward, xlstm.cache_shapes,
                    xlstm.init_cache, xlstm.decode_step, None,
                    xlstm.model_specs),
    "hybrid": ModelApi(hybrid.model_specs, hybrid.forward,
                       hybrid.cache_shapes, hybrid.init_cache,
                       hybrid.decode_step, None, hybrid.model_specs),
    "audio": ModelApi(encdec.model_specs, encdec.forward,
                      encdec.cache_shapes, encdec.init_cache,
                      encdec.decode_step, None, encdec.model_specs),
    "tiny": ModelApi(lstm_tiny.model_specs, lstm_tiny.forward,
                     lstm_tiny.cache_shapes, lstm_tiny.init_cache,
                     lstm_tiny.decode_step, None, lstm_tiny.model_specs),
}


def get_model(cfg) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the port has "
                         f"{sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def param_specs(cfg):
    """The serving parameter layout."""
    return get_model(cfg).specs(cfg)


def train_param_specs(cfg):
    """The trainable parameter layout: the JAX package's `param_specs`
    (transformer layers stacked `[L, ...]`)."""
    return get_model(cfg).train_specs(cfg)


def param_axes(cfg):
    """Logical axes of the trainable layout (the JAX package's
    `param_axes`)."""
    return axes_tree(train_param_specs(cfg))


# ------------------------------------------------------------- inputs
def input_specs(cfg, shape_cfg) -> dict:
    """{name: (shape, dtype)} of every model input of one step."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    i32 = torch.int32
    if shape_cfg.kind in ("train", "prefill"):
        batch = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = ((B, cfg.n_frontend_tokens, cfg.d_model),
                                     torch.float32)
        if cfg.family == "audio":
            batch["frames"] = ((B, encdec.src_len(cfg, S), cfg.d_model),
                               torch.float32)
        return batch
    # decode: ONE new token against a seq_len cache
    return {"token": ((B, 1), i32), "index": ((), i32)}


def input_axes(cfg, shape_cfg) -> dict:
    """Logical axes of each input of `input_specs`."""
    if shape_cfg.kind in ("train", "prefill"):
        ax = {"tokens": ("batch", None), "labels": ("batch", None)}
        if cfg.frontend == "vision":
            ax["patch_embeds"] = ("batch", None, None)
        if cfg.family == "audio":
            ax["frames"] = ("batch", None, None)
        return ax
    return {"token": ("batch", None), "index": ()}


def input_sds(cfg, shape_cfg) -> dict:
    """`input_specs` as meta tensors (no allocation)."""
    return {k: torch.empty(shp, dtype=dt, device="meta")
            for k, (shp, dt) in input_specs(cfg, shape_cfg).items()}


# ------------------------------------------------------------- losses
def lm_loss(logits: torch.Tensor, batch: dict, cfg) -> torch.Tensor:
    """Next-token CE over the label positions, in float32; label 0 is
    padding and carries no loss."""
    labels = batch["labels"]
    S = labels.shape[1]
    logits = logits[:, -S:][:, :-1]              # drop any prefix
    targets = labels[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (targets != 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
