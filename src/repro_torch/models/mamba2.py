"""Mamba2 (SSD) block — the port of `repro/models/mamba2.py`: the
chunkwise-parallel training scan and the O(1) decode step.

The chunked SSD algorithm keeps the JAX package's blocking: chunks of
CHUNK tokens, an intra-chunk [Q, Q] score matrix per head (`seg`,
`decay` and `CB` in float32), chunk states, and an inter-chunk scan that
hands each chunk the state BEFORE it. It is plain torch einsums: the
JAX package computes it outside any Pallas kernel. The SSM state h
[B, n_heads, head_dim, d_state] and the conv history are float32, as in
the JAX package.

The causal depthwise conv sums its K shifted products in one order,
and the decode step sums its K history rows in the same order (the JAX
package's decode uses an einsum there), so in bf16 a decoded position's
conv output is the teacher-forced one bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_norm, linear, linear_specs,
                                       norm_specs)
from repro_torch.nn import Spec

CONV_K = 4
CHUNK = 128


def ssm_dims(cfg) -> tuple:
    """(d_inner, SSM heads, d_state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_state


def mamba_specs(cfg) -> dict:
    d = cfg.d_model
    d_inner, nh, ds = ssm_dims(cfg)
    return {
        "ln": norm_specs(d, cfg.norm),
        "wz": linear_specs(d, d_inner, ("embed", "mlp")),
        "wx": linear_specs(d, d_inner, ("embed", "mlp")),
        "wB": linear_specs(d, ds, ("embed", None)),
        "wC": linear_specs(d, ds, ("embed", None)),
        "wdt": linear_specs(d, nh, ("embed", None), bias=True),
        "conv_w": Spec((CONV_K, d_inner + 2 * ds), ("conv", "mlp"),
                       init="uniform", scale=0.5),
        "A_log": Spec((nh,), (None,), init="zeros"),
        "D": Spec((nh,), (None,), init="ones"),
        "ln_gate": norm_specs(d_inner, "rmsnorm"),
        "wo": linear_specs(d_inner, d, ("mlp", "embed")),
    }


def _conv_sum(rows, w) -> torch.Tensor:
    """sum_i rows[i] * w[i] in the order i = 0 .. K-1."""
    out = rows[0] * w[0]
    for i in range(1, w.shape[0]):
        out = out + rows[i] * w[i]
    return out


def _causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u [B,S,ch], w [K,ch] -> causal depthwise conv, silu-activated."""
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    return F.silu(_conv_sum([pad[:, i:i + S] for i in range(K)], w))


def _proj(p, x, cfg) -> tuple:
    z = linear(p["wz"], x)
    xin = linear(p["wx"], x)
    B_ = linear(p["wB"], x)
    C_ = linear(p["wC"], x)
    dt = F.softplus(linear(p["wdt"], x).float())
    return z, xin, B_, C_, dt


def ssd_chunked(xh, B_, C_, dt, A_log, D) -> torch.Tensor:
    """Chunkwise SSD. xh [B,S,nh,hd]; B_/C_ [B,S,ds]; dt [B,S,nh] f32.
    Returns y [B,S,nh,hd] in xh's dtype."""
    Bsz, S, nh, hd = xh.shape
    ds = B_.shape[-1]
    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: S {S} is not a multiple of {Q}")
    nc = S // Q
    A = -torch.exp(A_log.float())                               # [nh]
    alog = dt * A                                               # [B,S,nh]

    xf = xh.float().reshape(Bsz, nc, Q, nh, hd)
    Bc = B_.float().reshape(Bsz, nc, Q, ds)
    Cc = C_.float().reshape(Bsz, nc, Q, ds)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    cum = torch.cumsum(alog.reshape(Bsz, nc, Q, nh), dim=2)     # inclusive

    # intra-chunk: y[i] = sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) dt_j x_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,nc,i,j,nh]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    seg = torch.where(mask[:, :, None], seg, -torch.inf)
    decay = torch.exp(seg)
    CB = torch.einsum("bcid,bcjd->bcij", Cc, Bc)
    scores = CB[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", scores, xf)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
    dlast = torch.exp(cum[:, :, -1:, :] - cum) * dtc            # [B,nc,Q,nh]
    state = torch.einsum("bcjh,bcjhd,bcjs->bchds", dlast, xf, Bc)
    a_chunk = torch.exp(cum[:, :, -1])                          # [B,nc,nh]

    # inter-chunk scan over nc: chunk c reads the state before it
    h = torch.zeros((Bsz, nh, hd, ds), dtype=torch.float32,
                    device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = a_chunk[:, c, :, None, None] * h + state[:, c]
    h_prev = torch.stack(h_prev, 1)                             # [B,nc,nh,hd,ds]

    y_inter = torch.einsum("bcis,bchds->bcihd", Cc, h_prev) \
        * torch.exp(cum)[..., None]
    y = y_intra + y_inter + D.float()[:, None] * xf
    return y.reshape(Bsz, S, nh, hd).to(xh.dtype)


def apply_mamba_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence training / prefill pass. x [B,S,d]."""
    d_inner, nh, ds = ssm_dims(cfg)
    h = apply_norm(p["ln"], x, cfg.norm)
    z, xin, B_, C_, dt = _proj(p, h, cfg)
    u = torch.cat([xin, B_, C_], dim=-1)
    u = _causal_depthwise_conv(u, p["conv_w"].to(u.dtype))
    xin, B_, C_ = torch.split(u, [d_inner, ds, ds], dim=-1)
    xh = xin.reshape(*xin.shape[:2], nh, cfg.ssm_head_dim)
    y = ssd_chunked(xh, B_, C_, dt, p["A_log"], p["D"])
    y = y.reshape(*x.shape[:2], d_inner) * F.silu(z)
    y = apply_norm(p["ln_gate"], y, "rmsnorm")
    return x + linear(p["wo"], y)


# ------------------------------------------------------------- decode
def mamba_cache_shapes(cfg, n_layers: int, batch: int) -> dict:
    d_inner, nh, ds = ssm_dims(cfg)
    return {
        "ssm": ((n_layers, batch, nh, cfg.ssm_head_dim, ds),
                ("layers", "batch", "heads", None, None), torch.float32),
        "conv": ((n_layers, batch, CONV_K - 1, d_inner + 2 * ds),
                 ("layers", "batch", None, "mlp"), torch.float32),
    }


def apply_mamba_decode(p: dict, x: torch.Tensor, cfg, ssm_state,
                       conv_state) -> tuple:
    """x [B,1,d]; ssm_state [B,nh,hd,ds]; conv_state [B,K-1,ch]. Returns
    (y [B,1,d], new ssm_state, new conv_state)."""
    d_inner, nh, ds = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    h = apply_norm(p["ln"], x, cfg.norm)
    z, xin, B_, C_, dt = _proj(p, h, cfg)
    u = torch.cat([xin, B_, C_], dim=-1)[:, 0]                  # [B,ch]
    w = p["conv_w"].to(u.dtype)
    hist = torch.cat([conv_state.to(u.dtype), u[:, None]], dim=1)
    conv_out = F.silu(_conv_sum(hist.unbind(1), w))
    new_conv = hist[:, 1:]
    xin, B_, C_ = torch.split(conv_out, [d_inner, ds, ds], dim=-1)
    xh = xin.reshape(-1, nh, hd).float()
    Bf, Cf = B_.float(), C_.float()
    dt1 = dt[:, 0]                                              # [B,nh]
    a = torch.exp(dt1 * -torch.exp(p["A_log"].float())[None])
    upd = torch.einsum("bh,bhd,bs->bhds", dt1, xh, Bf)
    new_ssm = a[..., None, None] * ssm_state + upd
    y = torch.einsum("bs,bhds->bhd", Cf, new_ssm) \
        + p["D"].float()[None, :, None] * xh
    y = y.reshape(-1, 1, d_inner).to(x.dtype) * F.silu(z)
    y = apply_norm(p["ln_gate"], y, "rmsnorm")
    return (x + linear(p["wo"], y), new_ssm,
            new_conv.to(conv_state.dtype))
