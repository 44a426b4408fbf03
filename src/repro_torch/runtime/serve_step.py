"""Decode (serving) steps: one new token — or one bucketed prompt chunk —
against a seq_len KV cache, dense or paged. The port of
`repro/runtime/serve_step.py`; every step updates its cache in place.

The chunked-prefill contract: `make_prefill_step(...)` returns
    prefill(params, cache, tokens [B,C], start [B], n_valid [B])
        -> (last_logits [B,V] fp32, cache)
where row b consumes chunk tokens 0..n_valid[b]-1 at cache positions
start[b].. and rows with n_valid=0 are untouched. Two implementations:

  * "scan"  — replays the family's own decode_step position by position,
    writing only the rows still inside their chunk.
  * "fused" — the family's vectorized prefill_step: bulk KV column insert
    + one prefill attention launch per layer and chunk.

"auto" is fused for a model on CUDA (the kernel path) and scan on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.models import api as M
from repro_torch.models import transformer
from repro_torch.runtime.train_step import window_for


def make_decode_step(cfg, shape_cfg):
    """decode_step(params, cache, token [B,1], index [B], active [B] or
    None) over a dense per-slot cache; inactive rows' writes are not
    made."""
    model = M.get_model(cfg)
    window = window_for(cfg, shape_cfg)

    def decode_step(params, cache, token, index, active=None):
        return model.decode_step(params, cache, token, index, cfg, window,
                                 active=active)

    return decode_step


def cache_specs(cfg, shape_cfg) -> tuple:
    """(meta-tensor tree, logical-axes tree) of the dense decode cache of
    `shape_cfg` (global_batch rows, seq_len columns)."""
    shapes = M.get_model(cfg).cache_shapes(cfg, shape_cfg.global_batch,
                                           shape_cfg.seq_len)
    sds = {k: torch.empty(sh, dtype=dt, device="meta")
           for k, (sh, ax, dt) in shapes.items()}
    return sds, {k: ax for k, (sh, ax, dt) in shapes.items()}


def _check_paged(cfg):
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"paged KV unsupported for family {cfg.family!r}")


def make_paged_decode_step(cfg, shape_cfg, page_size: int):
    """Decode against the shared page pool. `tables` [B, n_lp] per-slot
    page tables; `active` [B] bool — inactive rows' pool writes are not
    made (the pool has no batch axis to select over)."""
    _check_paged(cfg)
    model = M.get_model(cfg)
    window = window_for(cfg, shape_cfg)

    def decode_step(params, cache, token, index, tables, active):
        pages = {"tables": tables, "page_size": page_size, "active": active}
        return model.decode_step(params, cache, token, index, cfg, window,
                                 pages=pages)

    return decode_step


def resolve_prefill_impl(model, impl: str, device) -> str:
    if impl == "auto":
        impl = "fused" if (torch.device(device).type == "cuda"
                           and model.prefill_step is not None) else "scan"
    if impl == "fused" and model.prefill_step is None:
        raise ValueError("family has no fused prefill_step")
    if impl not in ("scan", "fused"):
        raise ValueError(f"unknown prefill impl {impl!r}")
    return impl


def logit_width(cfg) -> int:
    """Width of the serving logits: the tiny classifier's 2 classes, else
    the vocabulary."""
    return 2 if cfg.family == "tiny" else cfg.vocab_size


def _scan_prefill(step, tokens, start, n_valid, V):
    """Feed the chunk through `step(tok [B,1], index [B], active [B])`
    one position at a time; keep each row's last valid logits."""
    B, C = tokens.shape
    lg = torch.zeros((B, V), dtype=torch.float32, device=tokens.device)
    for i in range(C):
        act = i < n_valid
        logits = step(tokens[:, i:i + 1], start + i, act)
        lg = torch.where((n_valid - 1 == i)[:, None], logits[:, 0].float(),
                         lg)
    return lg


def make_prefill_step(cfg, shape_cfg, impl: str = "auto", device="cuda"):
    """Chunked prefill over a dense per-slot cache."""
    model = M.get_model(cfg)
    window = window_for(cfg, shape_cfg)
    impl = resolve_prefill_impl(model, impl, device)

    if impl == "fused":
        def prefill_fused(params, cache, tokens, start, n_valid):
            return model.prefill_step(params, cache, tokens, start, n_valid,
                                      cfg, window)
        return prefill_fused

    def prefill_scan(params, cache, tokens, start, n_valid):
        def step(tok, idx, act):
            return model.decode_step(params, cache, tok, idx, cfg, window,
                                     active=act)[0]
        return _scan_prefill(step, tokens, start, n_valid,
                             logit_width(cfg)), cache

    return prefill_scan


def make_paged_prefill_step(cfg, shape_cfg, page_size: int,
                            impl: str = "auto", device="cuda"):
    """Chunked prefill over the shared page pool; the step additionally
    takes `tables` [B, n_lp]."""
    _check_paged(cfg)
    model = M.get_model(cfg)
    window = window_for(cfg, shape_cfg)
    impl = resolve_prefill_impl(model, impl, device)

    if impl == "fused":
        def prefill_fused(params, cache, tokens, start, n_valid, tables):
            pages = {"tables": tables, "page_size": page_size,
                     "active": None}
            return model.prefill_step(params, cache, tokens, start, n_valid,
                                      cfg, window, pages=pages)
        return prefill_fused

    def prefill_scan(params, cache, tokens, start, n_valid, tables):
        def step(tok, idx, act):
            pages = {"tables": tables, "page_size": page_size,
                     "active": act}
            return model.decode_step(params, cache, tok, idx, cfg, window,
                                     pages=pages)[0]
        return _scan_prefill(step, tokens, start, n_valid,
                             logit_width(cfg)), cache

    return prefill_scan
