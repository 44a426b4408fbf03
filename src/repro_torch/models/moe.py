"""Mixture-of-Experts layer — the port of `repro/models/moe.py` on one
device: capacity dispatch into a compact `[E, C, d]` buffer (the
`[T, E, C]` one-hot never exists), top-k gates renormalised, and the
Switch-style load-balance loss.

The JAX package picks between the token-chunked dispatch
(`_moe_chunked` -> `_single` or one `_moe_core` per chunk) and, under a
mesh with a `model` axis that divides the experts and at >= 2,048
tokens, the expert-parallel `_moe_ep` (`shard_map`: each model shard
dispatches to its own experts, then one psum). On one card the `model`
axis has one shard, and `_moe_ep`'s arithmetic there is `_moe_chunked`'s
(bit for bit in the JAX package too): the window of experts is all of
them (`e_lo` 0), the chunks are `auto_chunk`'s, the psum and pmeans are
over one shard, and the lb / dropped means over one chunk equal the
chunk's own values. So the port has the one function; where JAX would
select `_moe_ep` over a `model` axis of more than one device,
`apply_moe` raises: sharding across cards is not part of the port.
The expert products are plain batched matmuls: the JAX package
computes them outside any Pallas kernel.

What has to match the reference beyond plain arithmetic:
  * routing is in float32 whatever the activation dtype;
  * top-k ties go to the lower expert index, as `jax.lax.top_k` does
    (`torch.topk` promises no order among equal values, so the port
    takes the first k of a stable descending sort);
  * a (token, choice) pair's slot in its expert is its arrival order
    over the token-major flattening `[T * k]`, and pairs past the
    capacity C are dropped (they land in a discarded row `E * C`);
  * the capacity is per call (per chunk), so what is dropped depends on
    which tokens share the call.
Returns (y, aux) with aux = {"lb_loss", "dropped_frac"}.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_mlp, linear, linear_specs,
                                       mlp_specs)
from repro_torch.nn import Spec
from repro_torch.nn.sharding import current_mesh, refuse_model_split


def moe_specs(cfg) -> dict:
    d, ff, E = cfg.d_model, cfg.expert_ff, cfg.n_experts
    s = {
        "router": linear_specs(d, E, ("embed", None)),
        "wi": Spec((E, d, ff), ("experts", "embed", "expert_mlp"),
                   init="fan_in"),
        "wg": Spec((E, d, ff), ("experts", "embed", "expert_mlp"),
                   init="fan_in"),
        "wo": Spec((E, ff, d), ("experts", "expert_mlp", "embed"),
                   init="fan_in"),
    }
    if cfg.shared_expert:
        s["shared"] = mlp_specs(cfg, ff)
    return s


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for `n_tokens` tokens: ceil(T * k / E * factor)
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def auto_chunk(T: int, cfg) -> int:
    """Largest token chunk <= moe_chunk (16,384 by default) that divides
    T: chunked dispatch bounds the `[chunk * k, d]` scatter rows."""
    target = cfg.moe_chunk or 16_384
    c = min(T, target)
    while T % c:
        c -= 1
    return c


# below this many tokens the JAX package's expert-parallel path costs
# more than the scatter it replaces
EP_MIN_TOKENS = 2048


def apply_moe(p: dict, x: torch.Tensor, cfg) -> tuple:
    """x [B, S, d] -> (y [B, S, d], aux). Where the JAX package selects
    its expert-parallel `_moe_ep`, a `model` axis of more than one
    device raises; at one shard `_moe_ep` is the chunked dispatch."""
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.shape \
            and cfg.n_experts % mesh.shape["model"] == 0 \
            and x.shape[0] * x.shape[1] >= EP_MIN_TOKENS:
        refuse_model_split("expert parallelism")
    return _moe_chunked(p, x, cfg)


def _moe_chunked(p: dict, x: torch.Tensor, cfg) -> tuple:
    """Token-chunked dispatch: each chunk of the flattened tokens routes,
    dispatches and combines on its own (the router is token-local, so
    only the capacity becomes per chunk); aux is the mean over chunks."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    chunk = auto_chunk(T, cfg)
    if chunk == T:
        return _single(p, xf, cfg, B, S, d)
    ys, lb, dropped = [], [], []
    for xc in xf.split(chunk):
        y, aux = _moe_core(p, xc, cfg)
        ys.append(y)
        lb.append(aux["lb_loss"])
        dropped.append(aux["dropped_frac"])
    y = torch.cat(ys).reshape(B, S, d)
    if cfg.shared_expert:
        y = y + apply_mlp(p["shared"], x)
    return y, {"lb_loss": torch.stack(lb).mean(),
               "dropped_frac": torch.stack(dropped).mean()}


def _single(p, xf, cfg, B, S, d):
    y, aux = _moe_core(p, xf, cfg)
    y = y.reshape(B, S, d)
    if cfg.shared_expert:
        y = y + apply_mlp(p["shared"], xf.reshape(B, S, d))
    return y, aux


def top_k_lower_first(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries of each row, in
    descending order, equal values in ascending index order (the order
    `jax.lax.top_k` gives)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(p: dict, xf: torch.Tensor, cfg) -> tuple:
    """float32 routing of xf [T, d]: (probs [T, E], gates [T, k]
    renormalised, expert ids [T, k])."""
    logits = linear(p["router"], xf.float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k_lower_first(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _moe_core(p: dict, xf: torch.Tensor, cfg) -> tuple:
    """Capacity dispatch of xf [T, d] over all E experts (the JAX
    package's expert window [e_lo, e_lo + n_local) is all of them on one
    card). Returns (y [T, d], aux)."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)
    probs, gate, idx = route(p, xf, cfg)

    # slot of each (token, choice) in its expert, in flat arrival order
    eflat = idx.reshape(T * k)
    onehot = F.one_hot(eflat, E).to(torch.int32)                # [T*k, E]
    pos = (torch.cumsum(onehot, 0, dtype=torch.int32) * onehot).sum(-1) - 1
    keep = pos < C
    dest = torch.where(keep, eflat * C + pos.clamp(0, C - 1), E * C)

    # scatter into [E * C + 1, d]: row E * C takes the drops
    rows = xf.repeat_interleave(k, dim=0)                          # [T*k, d]
    buf = xf.new_zeros((E * C + 1, d)).index_put((dest,), rows)
    buf = buf[:E * C].reshape(E, C, d)

    h = F.silu(torch.bmm(buf, p["wg"].to(xf.dtype)))
    h = h * torch.bmm(buf, p["wi"].to(xf.dtype))
    out = torch.bmm(h, p["wo"].to(xf.dtype)).reshape(E * C, d)

    gathered = out[dest.clamp(0, E * C - 1)]
    gathered = gathered * keep[:, None].to(xf.dtype)
    y = (gathered.reshape(T, k, d) * gate[..., None].to(xf.dtype)).sum(1)

    # Switch-style load-balance loss: E * sum_e f_e * P_e, f_e over the
    # first choice only
    frac = F.one_hot(idx[:, 0], E).float().mean(0)
    lb_loss = E * torch.sum(frac * probs.mean(0))
    dropped = 1.0 - keep.float().sum() / (T * k)
    return y, {"lb_loss": lb_loss, "dropped_frac": dropped}
