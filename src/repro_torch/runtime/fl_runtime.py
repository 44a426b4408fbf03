"""Federated-learning runtimes (paper Alg. 1) — the port of
`repro/runtime/fl_runtime.py`.

`fl_round_tiny` — the paper's exact setting: N users, J local epochs
each (a loop over users), quantized weight upload through the channel,
FedAvg, broadcast.

`make_fl_train_step` — the scaled families' FL cycle (the JAX package's
pod-mesh step, here on one card): J local SGD-momentum steps per user
on that user's batch, then the quantized sync of the stacked model, one
packed-wire pass for all users (K1), or under `wcfg.use_kernel` the
fused quantize -> channel -> dequantize -> mean (K2). `schemes/scaled.py`
drives it and bills the sync by replaying its fade/ARQ draw on the same
key (`wire.drawn_stacked_tx` on `key.fold_in(999)`).
"""
from __future__ import annotations

import torch

from repro_torch.core import federated as FED
from repro_torch.core import wire as WIRE
from repro_torch.nn import tree_map
from repro_torch.runtime.train_step import TrainState, make_local_step

SYNC_KEY_FOLD = 999   # the sync's channel key is round key .fold_in(999)


def make_local_step_tiny(cfg, wcfg, lr, momentum: float = 0.9,
                         prox_mu: float = 0.0, anchor=None):
    """Local SGD step for the paper's tiny model — the shared
    `make_local_step` core (FL local steps are radio-free; `wcfg` is
    kept for call-site compatibility); with prox_mu > 0 it is FedProx,
    pulled toward `anchor` ({"model": broadcast, "codec": {}})."""
    del wcfg
    return make_local_step(cfg, lr, momentum, prox_mu, anchor)


def fl_round_tiny(key, user_states, user_batches, cfg, wcfg, lr):
    """One communication cycle k. user_batches leaves [N, J, ...]; `key`
    is a `core.draws.Key`. Returns (state, metrics [N, J], bits)."""
    local_step = make_local_step_tiny(cfg, wcfg, lr)
    states, metrics = FED.local_steps_vmapped(local_step, user_states,
                                              user_batches)
    avg, bits = FED.fedavg_through_channel(
        key.fold_in(SYNC_KEY_FOLD).draws(), states.trainable["model"], wcfg)
    new_trainable = dict(states.trainable, model=avg)
    return TrainState(new_trainable, states.opt_state, states.step), \
        metrics, bits


def _sum_users(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_u w[u] * r[u], users in ascending order, each product rounded
    before its add."""
    acc = r[0] * w[0]
    for u in range(1, r.shape[0]):
        acc = acc + r[u] * w[u]
    return acc


def make_fl_sync(wcfg, n_users: int):
    """The FL cycle's sync: sync_agg(key, model, fallback) sends the
    stacked `model` tree through the quantized channel on `key`'s draws
    and returns the FedAvg aggregate broadcast back to [n_users, ...],
    or the `fallback` leaves when every user's upload erased (bounded
    ARQ). Under `wcfg.use_kernel` one K2 launch computes the alive-
    weighted mean without the received [N, ...] tree; otherwise one K1
    launch delivers every (user, leaf) packet and the mean follows,
    erasure-aware under bounded ARQ (users with an erased packet weigh
    zero)."""
    arq_max_tx = int(wcfg.arq_max_tx)
    ge_p_gb, ge_p_bg = float(wcfg.ge_p_gb), float(wcfg.ge_p_bg)
    rounding = str(wcfg.rounding)
    use_kernel = bool(wcfg.use_kernel)
    if use_kernel and rounding != "nearest":
        raise ValueError("the fused-mean kernel sync (wcfg.use_kernel) "
                         "only rounds to nearest")
    link = dict(bits=wcfg.quant_bits, snr_db=wcfg.snr_db,
                fading=wcfg.fading, perfect=wcfg.perfect_channel,
                arq_attempts=wcfg.arq_attempts,
                arq_min_f2=wcfg.arq_min_f2, wire_dtype=wcfg.wire_dtype)

    def sync_agg(kch, model, fallback):
        draws = kch.draws()
        if use_kernel:
            mean_tree, diag = WIRE.transmit_stacked_mean(
                draws, model, impl="kernel", arq_max_tx=arq_max_tx,
                ge_p_gb=ge_p_gb, ge_p_bg=ge_p_bg, **link)
            if diag["n_alive"] == 0:
                return fallback
            return FED.replicate_for_users(mean_tree, n_users)
        fault_knobs = {}
        if arq_max_tx > 0 or ge_p_gb > 0.0 or rounding != "nearest":
            fault_knobs = dict(arq_max_tx=arq_max_tx, ge_p_gb=ge_p_gb,
                               ge_p_bg=ge_p_bg, rounding=rounding)
        received = WIRE.transmit_stacked(
            draws, model, return_diag=(arq_max_tx > 0), **link,
            **fault_knobs)
        if arq_max_tx > 0:
            received, diag = received
            alive = ~diag["erased"].any(dim=1)                    # [N]
            n_alive = int(alive.sum())
            if n_alive == 0:
                return fallback
            w = alive.float() / max(float(n_alive), 1.0)
            return tree_map(lambda r: _sum_users(r, w.to(r.device)).expand(
                r.shape), received)
        return tree_map(lambda r: FED.mean_users(r).expand(r.shape),
                        received)

    return sync_agg


def make_fl_train_step(cfg, shape_cfg, wcfg, n_users: int = 2,
                       lr: float = 3e-4, momentum: float = 0.9,
                       sync: str | None = None):
    """FL cycle for the scaled families. State trees carry a leading
    [n_users] axis; batch leaves are [n_users, local_batch, S] tensors
    on the state's device; `key` is a `core.draws.Key`.

    `sync` (default wcfg.sync):
      * "barrier" — J local steps, then the quantized sync whose
        aggregate this cycle consumes. fl_step(state, batch, key[, lr])
        -> (state, metrics).
      * "delayed" — one cycle of staleness: cycle k's local phase starts
        from cycle k-1's aggregate while its sync sends cycle k-1's
        local output. fl_step(carry, batch, key[, lr]) -> (carry,
        metrics), carry = {"state": TrainState, "agg": stacked model
        tree}, both seeded with the initial broadcast weights. An
        all-erased sync keeps the previous aggregate. The sync key, and
        so the bill, is the barrier one's.

    Each user's J local steps all run on that user's same batch (user u
    on key.split(n)[u].fold_in(j); the dense model draws nothing). The
    sync honors the link config: bounded ARQ (erasure-aware FedAvg:
    users with an erased packet weigh zero; if every user erased, each
    keeps its fallback), Gilbert-Elliott, `wire_dtype`, `rounding`, and
    `use_kernel` (K2, which rounds to nearest only)."""
    sync = str(getattr(wcfg, "sync", "barrier")) if sync is None else sync
    if sync not in ("barrier", "delayed"):
        raise ValueError(f"unknown sync mode {sync!r}")
    sync_agg = make_fl_sync(wcfg, n_users)

    def local_steps(state, batch, key, lr):
        local_step = make_local_step(cfg, lr, momentum)
        keys = key.split(n_users)
        states, mets = [], []
        for u in range(n_users):
            st = FED.user_slice(state, u)
            b = {k: v[u] for k, v in batch.items()}
            for j in range(wcfg.local_steps):
                st, m = local_step(st, b, keys[u].fold_in(j))
                mets.append(m)
            states.append(st)
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
        return FED.stack_users(states), metrics

    def fl_step(state: TrainState, batch: dict, key, lr=lr):
        state, metrics = local_steps(state, batch, key, lr)
        # fallback on an all-erased sync: each user keeps its own
        # pre-sync weights
        model = sync_agg(key.fold_in(SYNC_KEY_FOLD),
                         state.trainable["model"], state.trainable["model"])
        trainable = dict(state.trainable, model=model)
        return TrainState(trainable, state.opt_state, state.step), metrics

    def fl_step_delayed(carry: dict, batch: dict, key, lr=lr):
        state, agg = carry["state"], carry["agg"]
        st_in = TrainState(dict(state.trainable, model=agg),
                           state.opt_state, state.step)
        new_state, metrics = local_steps(st_in, batch, key, lr)
        new_agg = sync_agg(key.fold_in(SYNC_KEY_FOLD),
                           state.trainable["model"], agg)
        return {"state": new_state, "agg": new_agg}, metrics

    return fl_step_delayed if sync == "delayed" else fl_step
