"""xLSTM blocks (sLSTM + mLSTM) [arXiv:2405.04517] — the port of
`repro/models/xlstm.py`.

Layout: super-blocks of (slstm_every - 1) mLSTM blocks followed by one
sLSTM block. The parameters keep the JAX package's stacked leaves
(`mlstm` leaves `[n_super, n_m, ...]`, `slstm` leaves `[n_super, ...]`)
in one plain tree for training and serving alike, so the FL packets (one
per leaf) and their bills are JAX's. Both cell types are exponentially
gated with the max-stabiliser (m starts at -inf) and keep their state in
float32; the recurrences run step by step, as written, in a Python loop
over time (the JAX package's `lax.scan`; it runs no Pallas kernel here,
and the port runs plain torch ops). `forward` recomputes each
super-block in the backward pass when `cfg.remat` is set
(`torch.utils.checkpoint`, as `jax.checkpoint`): without it autograd
would keep several `[B, nh, hd, hd]` f32 matrix states for every time
step of every mLSTM layer. Decode carries (C, n, m) / (c, n, m, h)
states, O(1) per token; `decode_step` updates the cache IN PLACE and
returns it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (apply_norm, embed_lookup, embed_specs,
                                       linear, linear_specs, norm_specs,
                                       unembed)
from repro_torch.nn import Spec, resolve_device, stack_specs, tree_at


def _dims(cfg):
    nh = cfg.n_heads
    return nh, cfg.d_model // nh


# ------------------------------------------------------------- mLSTM
def mlstm_specs(cfg) -> dict:
    d = cfg.d_model
    nh, _ = _dims(cfg)
    return {
        "ln": norm_specs(d, cfg.norm),
        "wq": linear_specs(d, d, ("embed", "qkv")),
        "wk": linear_specs(d, d, ("embed", "qkv")),
        "wv": linear_specs(d, d, ("embed", "qkv")),
        "wi": linear_specs(d, nh, ("embed", None), bias=True),
        "wf": linear_specs(d, nh, ("embed", None), bias=True),
        "wo_gate": linear_specs(d, d, ("embed", "qkv")),
        "wo": linear_specs(d, d, ("qkv", "embed")),
    }


def _mlstm_gates(p, h, cfg) -> tuple:
    """q, k, v [B, S, nh, hd] in the activation dtype (q and k scaled by
    1/sqrt(hd)); input and log-forget gates [B, S, nh] f32; output gate
    [B, S, d]."""
    nh, hd = _dims(cfg)
    B, S, _ = h.shape
    q = linear(p["wq"], h).reshape(B, S, nh, hd) / math.sqrt(hd)
    k = linear(p["wk"], h).reshape(B, S, nh, hd) / math.sqrt(hd)
    v = linear(p["wv"], h).reshape(B, S, nh, hd)
    it = linear(p["wi"], h).float()
    ft = F.logsigmoid(linear(p["wf"], h).float())
    og = torch.sigmoid(linear(p["wo_gate"], h))
    return q, k, v, it, ft, og


def mlstm_cell(state, inp) -> tuple:
    """One timestep. state: (C [B,nh,hd,hd], n [B,nh,hd], m [B,nh]) f32;
    inp: (q, k, v [B,nh,hd], it, ft [B,nh]). Returns (state, y
    [B,nh,hd] f32)."""
    y, state = _mlstm_scan(*(a[:, None] for a in inp), state)
    return state, y[:, 0]


def mlstm_state0(B: int, nh: int, hd: int, device) -> tuple:
    f32 = torch.float32
    return (torch.zeros((B, nh, hd, hd), dtype=f32, device=device),
            torch.zeros((B, nh, hd), dtype=f32, device=device),
            torch.full((B, nh), -math.inf, dtype=f32, device=device))


def _mlstm_scan(q, k, v, it, ft, state=None) -> tuple:
    """The mLSTM recurrence over the steps of a sequence: q, k, v [B, S,
    nh, hd], it, ft [B, S, nh], from `state` (C, n, m) or the zero state
    (m = -inf). Returns (y [B, S, nh, hd] f32, the last state). Per step,
    as the JAX cell: m_new = max(ft + m, it); i_p = exp(it - m_new);
    f_p = exp(ft + m - m_new); C = f_p C + i_p v k^T; n = f_p n + i_p k;
    y = C q / max(|n . q|, 1), all in f32.

    Laid out for few launches a step: the stabiliser m runs its own
    recurrence first, so i_p and f_p are computed for all steps at once;
    C and n are one state [B*nh, hd + 1, hd] (n is the last row), updated
    by one outer product (`baddbmm` of [i_p v; i_p] and k onto f_p *
    state) and read by one product with q, which gives C.q and n.q
    together; the division is done for all steps after the loop."""
    B, S, nh, hd = q.shape
    C, n, m = state if state is not None else \
        mlstm_state0(B, nh, hd, q.device)
    qf, kf, vf = (a.float().transpose(1, 2).reshape(B * nh, S, hd)
                  for a in (q, k, v))
    it, ft = (a.transpose(1, 2).reshape(B * nh, S) for a in (it, ft))
    m0 = m.reshape(B * nh)
    m, ms = m0, []
    for it_t, ft_t in zip(it.unbind(1), ft.unbind(1)):
        m = torch.maximum(ft_t + m, it_t)
        ms.append(m)
    m = torch.stack(ms, 1)                                    # [B*nh, S]
    m_prev = torch.cat([m0[:, None], m[:, :-1]], 1)
    i_p = torch.exp(it - m)
    f_p = torch.exp(ft + m_prev - m)
    va = torch.cat([i_p[..., None] * vf, i_p[..., None]], -1)  # [., S, hd+1]
    aug = torch.cat([C, n[..., None, :]], -2).reshape(B * nh, hd + 1, hd)
    outs = []
    for f_t, v_t, k_t, q_t in zip(f_p[:, :, None, None].unbind(1),
                                  va[..., None].unbind(1),
                                  kf[:, :, None, :].unbind(1),
                                  qf[..., None].unbind(1)):
        aug = torch.baddbmm(f_t * aug, v_t, k_t)
        outs.append(torch.bmm(aug, q_t))
    out = torch.cat(outs, -1).transpose(1, 2)              # [B*nh, S, hd+1]
    y = out[..., :hd] / torch.clamp(torch.abs(out[..., hd:]), min=1.0)
    aug = aug.reshape(B, nh, hd + 1, hd)
    return y.reshape(B, nh, S, hd).transpose(1, 2), (
        aug[:, :, :hd], aug[:, :, hd], ms[-1].reshape(B, nh))


def apply_mlstm(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    B, S, d = x.shape
    h = apply_norm(p["ln"], x, cfg.norm)
    q, k, v, it, ft, og = _mlstm_gates(p, h, cfg)
    y = _mlstm_scan(q, k, v, it, ft)[0].reshape(B, S, d).to(x.dtype) * og
    return x + linear(p["wo"], y)


# ------------------------------------------------------------- sLSTM
def slstm_specs(cfg) -> dict:
    d = cfg.d_model
    nh, hd = _dims(cfg)
    return {
        "ln": norm_specs(d, cfg.norm),
        "wx": linear_specs(d, 4 * d, ("embed", "qkv"), bias=True),
        "r": Spec((nh, hd, 4 * hd), ("heads", None, None), init="fan_in"),
        "wo": linear_specs(d, d, ("qkv", "embed")),
    }


def _slstm_update(z, c, n, m) -> tuple:
    """The sLSTM's gates from its pre-activations z [..., 4 hd] (input,
    forget, cell, output) and the state update. Returns (c, n, m, h)."""
    it, ft, zt, ot = torch.split(z, z.shape[-1] // 4, dim=-1)
    ft = F.logsigmoid(ft)
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c = f_p * c + i_p * torch.tanh(zt)
    n = f_p * n + i_p
    h_new = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return c, n, m_new, h_new


def slstm_cell(p, state, xt, cfg) -> tuple:
    """state: (c, n, m, h) each [B,nh,hd] f32; xt [B,4d] f32. Returns
    (state, h_new)."""
    hs, state = _slstm_scan(xt[:, None], p["r"], cfg, state)
    return state, hs[:, 0]


def slstm_state0(B: int, nh: int, hd: int, device) -> tuple:
    z = torch.zeros((B, nh, hd), dtype=torch.float32, device=device)
    return (z, z, torch.full_like(z, -math.inf), z)


def _slstm_scan(xproj, r, cfg, state=None) -> tuple:
    """The sLSTM recurrence over a sequence: xproj [B, S, 4d] (the input
    projection), recurrent weights r [nh, hd, 4 hd], from `state` (c, n,
    m, h) or the zero state (m = -inf). Returns (h [B, S, nh, hd], the
    last state). Heads lead inside the loop ([nh, B, ...]), so each
    step's recurrent product and its input add are one `baddbmm` (the
    JAX cell's einsum("bhd,hde->bhe", h, r) + xt)."""
    nh, hd = _dims(cfg)
    B, S, _ = xproj.shape
    xs = xproj.float().reshape(B, S, nh, 4 * hd).permute(1, 2, 0, 3)
    state = state if state is not None else \
        slstm_state0(B, nh, hd, xproj.device)
    c, n, m, h = (a.transpose(0, 1) for a in state)      # [nh, B, hd]
    r, hs = r.float(), []
    for x_t in xs.unbind(0):
        c, n, m, h = _slstm_update(torch.baddbmm(x_t, h, r), c, n, m)
        hs.append(h)
    return torch.stack(hs, 2).permute(1, 2, 0, 3), tuple(
        a.transpose(0, 1) for a in (c, n, m, h))


def apply_slstm(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    B, S, d = x.shape
    hin = apply_norm(p["ln"], x, cfg.norm)
    hs, _ = _slstm_scan(linear(p["wx"], hin), p["r"], cfg)
    return x + linear(p["wo"], hs.reshape(B, S, d).to(x.dtype))


# ------------------------------------------------------------- model
def super_block_layout(cfg) -> tuple:
    """n_layers split into super-blocks of (per-1) mLSTM + 1 sLSTM:
    (n_super, mLSTM blocks a super-block)."""
    per = cfg.slstm_every or cfg.n_layers
    if cfg.n_layers % per:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"slstm_every {per}")
    return cfg.n_layers // per, per - 1 if cfg.slstm_every else per


def model_specs(cfg) -> dict:
    n_super, n_m = super_block_layout(cfg)
    s = {
        "embed": embed_specs(cfg.vocab_size, cfg.d_model),
        "mlstm": stack_specs(stack_specs(mlstm_specs(cfg), n_m, "inner"),
                             n_super),
        "ln_f": norm_specs(cfg.d_model, cfg.norm),
    }
    if cfg.slstm_every:
        s["slstm"] = stack_specs(slstm_specs(cfg), n_super)
    return s


def _super_block(x, mstack, slp, cfg):
    for i in range(super_block_layout(cfg)[1]):
        x = apply_mlstm(tree_at(mstack, i), x, cfg)
    if slp is not None:
        x = apply_slstm(slp, x, cfg)
    return x


def run_superblocks(params, x, cfg, lo: int, hi: int) -> torch.Tensor:
    """x through super-blocks [lo, hi), each recomputed in the backward
    pass when `cfg.remat` is set and autograd records."""
    slstm = params.get("slstm")
    for s in range(lo, hi):
        mstack = tree_at(params["mlstm"], s)
        slp = tree_at(slstm, s) if slstm is not None else None
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_super_block, x, mstack, slp, cfg,
                           use_reentrant=False)
        else:
            x = _super_block(x, mstack, slp, cfg)
    return x


def forward(params: dict, batch: dict, cfg, window: int = 0) -> tuple:
    x = embed_lookup(params["embed"], batch["tokens"], cfg.dtype)
    x = run_superblocks(params, x, cfg, 0, super_block_layout(cfg)[0])
    x = apply_norm(params["ln_f"], x, cfg.norm)
    return unembed(params["embed"], x), {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}


# ------------------------------------------------------------- decode
def cache_shapes(cfg, batch: int, seq_len: int) -> dict:
    nh, hd = _dims(cfg)
    n_super, n_m = super_block_layout(cfg)
    f32 = torch.float32
    sh = {
        "mC": ((n_super, n_m, batch, nh, hd, hd),
               ("layers", None, "batch", "heads", None, None), f32),
        "mn": ((n_super, n_m, batch, nh, hd),
               ("layers", None, "batch", "heads", None), f32),
        "mm": ((n_super, n_m, batch, nh),
               ("layers", None, "batch", "heads"), f32),
    }
    if cfg.slstm_every:
        for nm in ("sc", "sn", "sm", "sh"):
            sh[nm] = ((n_super, batch, nh, hd),
                      ("layers", "batch", "heads", None), f32)
    return sh


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {name: torch.full(shape, -math.inf if name in ("mm", "sm")
                             else 0.0, dtype=dtype, device=dev)
            for name, (shape, axes, dtype) in
            cache_shapes(cfg, batch, seq_len).items()}


def decode_step(params, cache: dict, token: torch.Tensor, index, cfg,
                window: int = 0, active=None) -> tuple:
    """token [B,1] int -> (logits [B,1,V], cache) with the cache's states
    updated IN PLACE; `index` is unused (the state is O(1) in the
    position). `active` [B] bool keeps the inactive rows' states."""
    x = embed_lookup(params["embed"], token, cfg.dtype)     # [B,1,d]
    B = x.shape[0]

    def put(leaf, new):
        if active is not None:
            shape = (B,) + (1,) * (new.ndim - 1)
            new = torch.where(active.reshape(shape), new, leaf)
        leaf.copy_(new)

    slstm = params.get("slstm")
    n_super, n_m = super_block_layout(cfg)
    for s in range(n_super):
        mstack = tree_at(params["mlstm"], s)
        for i in range(n_m):
            mp = tree_at(mstack, i)
            h = apply_norm(mp["ln"], x, cfg.norm)
            q, k, v, it, ft, og = _mlstm_gates(mp, h, cfg)
            st = (cache["mC"][s, i], cache["mn"][s, i], cache["mm"][s, i])
            st, y = mlstm_cell(st, (q[:, 0], k[:, 0], v[:, 0], it[:, 0],
                                    ft[:, 0]))
            for name, new in zip(("mC", "mn", "mm"), st):
                put(cache[name][s, i], new)
            y = y.reshape(B, 1, -1).to(x.dtype) * og
            x = x + linear(mp["wo"], y)
        if slstm is not None:
            slp = tree_at(slstm, s)
            hin = apply_norm(slp["ln"], x, cfg.norm)
            xproj = linear(slp["wx"], hin).float()[:, 0]
            st = tuple(cache[n][s] for n in ("sc", "sn", "sm", "sh"))
            st, hs = slstm_cell(slp, st, xproj, cfg)
            for name, new in zip(("sc", "sn", "sm", "sh"), st):
                put(cache[name][s], new)
            x = x + linear(slp["wo"], hs.reshape(B, 1, -1).to(x.dtype))
    x = apply_norm(params["ln_f"], x, cfg.norm)
    return unembed(params["embed"], x), cache
