"""FederatedScheme: the paper's FL (Alg. 1) behind the Scheme API — the
port of `repro/schemes/federated.py`.

One `round` = J local epochs per user, one quantized N-user weight
upload through the packed wire (`radio.send_stacked`: one pass, one
packet per (user, tensor), one kernel launch on the card), FedAvg
(Eq. 3), broadcast back. Bounded-ARQ erasures and the quorum rule are
handled as in the JAX package. Privacy capture (`capture=True`) records
each sync's received weight deltas off the same stacked payload the
average uses, so capturing never perturbs the trajectory. DP uploads,
FedProx, sampling with replacement and the coordinate-median aggregate
are still to port (ROADMAP.md) and raise.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig
from repro_torch.core import federated as FED
from repro_torch.core.draws import Key
from repro_torch.data.sentiment import partition_users
from repro_torch.nn import resolve_device, tree_leaves, tree_map
from repro_torch.runtime.fl_runtime import (SYNC_KEY_FOLD,
                                            make_local_step_tiny)
from repro_torch.runtime.train_step import TrainState, init_train_state
from repro_torch.schemes.base import (BATCH, CFG, MOMENTUM, RoundReport,
                                      SchemeState, batches_of, evaluate,
                                      step_flops)
from repro_torch.schemes.radio import Radio


@functools.lru_cache(maxsize=16)
def _local_step(lr: float):
    return make_local_step_tiny(CFG, None, lr, MOMENTUM)


def draw_local_epochs(xu, yu, local_epochs: int, rng):
    """One FL client's round of training data: `local_epochs` shuffled
    epochs of BATCH-sized batches -> ([J, B, S], [J, B]) numpy, the
    JAX package's rng stream."""
    j = local_epochs * (len(xu) // BATCH)
    toks = np.empty((j, BATCH, xu.shape[1]), np.int32)
    labs = np.empty((j, BATCH), np.int32)
    bi = 0
    for _ in range(local_epochs):
        for b in batches_of(xu, yu, BATCH, rng):
            toks[bi] = b["tokens"].numpy()
            labs[bi] = b["labels"].numpy()
            bi += 1
    return toks, labs


def flat_uploads(received, pre_broadcast) -> np.ndarray:
    """[N, P] received weight deltas (against the cycle's broadcast
    weights), leaves in the tree's order: the FL privacy observation."""
    return torch.cat([(r - p[None]).reshape(r.shape[0], -1)
                      for r, p in zip(tree_leaves(received),
                                      tree_leaves(pre_broadcast))],
                     dim=1).cpu().numpy()


def fl_capture(captures, received, broadcast, user_tokens) -> None:
    """Record one FL sync's privacy observations: the received weight
    deltas (`flat_uploads`) and, as the reconstruction target, each
    user's mean token vector over the round (numpy's float64 mean, as in
    the JAX package). `user_tokens`: the round's tokens per user."""
    captures["deltas"].append(flat_uploads(received, broadcast))
    captures["targets"].append(np.stack(
        [t.reshape(-1, t.shape[-1]).mean(0) for t in user_tokens]))


def _not_ported(what: str):
    raise NotImplementedError(f"FederatedScheme: {what} is not ported yet "
                              f"(see ROADMAP.md)")


class FederatedScheme:
    mode = "fl"

    def __init__(self, wcfg=None, capture: bool = False,
                 dp_sigma: float = 0.0, prox_mu: float = 0.0,
                 sample_with_replacement: bool = False,
                 quorum: float = 0.0, device="cuda", key=Key):
        if capture and dp_sigma > 0:
            raise ValueError("capture=True is not supported with "
                             "dp_sigma > 0 (DP uploads are not observed)")
        if dp_sigma > 0:
            _not_ported("DP-FedAvg (dp_sigma > 0)")
        if prox_mu > 0:
            _not_ported("FedProx (prox_mu > 0)")
        if sample_with_replacement:
            _not_ported("sample_with_replacement=True")
        self.wcfg = wcfg or WirelessConfig(mode="fl")
        if self.wcfg.aggregate != "mean":
            _not_ported(f"aggregate={self.wcfg.aggregate!r}")
        self.device = resolve_device(device)
        self.key = key              # seed -> root Key (the draw seam)
        self.quorum = float(quorum)
        self.radio = Radio.from_wcfg(self.wcfg)
        self.n_users = self.wcfg.n_users
        self.local_epochs = self.wcfg.local_steps
        self.epochs_per_cycle = self.local_epochs
        self.bits_normalizer = float(self.n_users)   # report per-user bits
        self.capture = capture
        self.captures = {"deltas": [], "targets": []} if capture else {}

    # ------------------------------------------------------------- setup
    def init(self, seed: int, xtr, ytr):
        shards = partition_users(xtr, ytr, self.n_users)
        self._spe = len(shards[0][0]) // BATCH
        g = torch.Generator().manual_seed(seed)
        state0 = init_train_state(g, CFG, None, "sgd", MOMENTUM,
                                  self.device)
        return SchemeState(train=FED.broadcast_state(state0, self.n_users),
                           data=shards), None

    def cycle_batches(self, state, rng, cycle):
        shards = state.data
        j = self.local_epochs * self._spe
        seq = shards[0][0].shape[1]
        toks = np.empty((self.n_users, j, BATCH, seq), np.int32)
        labs = np.empty((self.n_users, j, BATCH), np.int32)
        for u, (xu, yu) in enumerate(shards):
            toks[u], labs[u] = draw_local_epochs(xu, yu, self.local_epochs,
                                                 rng)
        return {"tokens": toks, "labels": labs}

    def round_key(self, seed: int, cycle: int):
        return self.key(seed + 3).fold_in(cycle)

    # ------------------------------------------------------------- round
    def round(self, state, batch, key, lr):
        j = batch["tokens"].shape[1]
        broadcast = tree_map(lambda p: p[0], state.train.trainable["model"])
        tb = {k: torch.from_numpy(v).to(self.device)
              for k, v in batch.items()}
        # --- local phase (Alg. 1 lines 3-7), one user after another
        states, metrics = FED.local_steps_vmapped(_local_step(lr),
                                                  state.train, tb)
        # --- quantized channel upload + aggregation (lines 8-17)
        user_params = states.trainable["model"]
        dlv = self.radio.send_stacked(key.fold_in(SYNC_KEY_FOLD).draws(),
                                      user_params)
        if self.capture:
            fl_capture(self.captures, dlv.payload, broadcast,
                       [batch["tokens"][u] for u in range(self.n_users)])
        # users whose upload was erased (bounded ARQ) carry zero weight;
        # below quorum the sync is abandoned and everyone re-anchors on
        # the cycle's broadcast weights
        erased = dlv.user_erased or (False,) * self.n_users
        kept = [u for u in range(self.n_users) if not erased[u]]
        need = max(1, math.ceil(self.quorum * self.n_users))
        fmetrics = {}
        if self.radio.arq_max_tx > 0:
            fmetrics = {"n_erased_users": self.n_users - len(kept),
                        "quorum_met": len(kept) >= need}
        if len(kept) == self.n_users:
            rx = dlv.payload
        elif len(kept) >= need:
            sel = torch.as_tensor(kept, device=self.device)
            rx = tree_map(lambda r: r[sel], dlv.payload)
        else:
            rx = None      # abandoned round
        avg = broadcast if rx is None else tree_map(FED.mean_users, rx)
        synced = FED.replicate_for_users(avg, self.n_users)       # Eq. 4
        new_train = TrainState(dict(states.trainable, model=synced),
                               states.opt_state, states.step)
        new = SchemeState(new_train, state.data, state.steps + j,
                          state.epoch + self.local_epochs)
        loss = float(metrics["loss"].cpu().numpy().mean())
        return new, RoundReport(loss=loss, steps=j, bits=dlv.bits,
                                n_tx=dlv.n_tx, energy_j=dlv.energy_j,
                                metrics=fmetrics,
                                erased_bits=dlv.erased_bits,
                                outage_s=dlv.outage_s)

    # -------------------------------------------------------------- eval
    def evaluate(self, state, xte, yte) -> float:
        gp = tree_map(lambda p: p[0], state.train.trainable["model"])
        return evaluate(gp, xte, yte)[0]

    def flops(self, steps_total: int):
        # full-model fwd+bwd per local step, per user; server only avgs
        return step_flops("cl") * steps_total, 0.0
