"""FederatedScheme: the paper's FL (Alg. 1) behind the Scheme API — the
port of `repro/schemes/federated.py`.

One `round` = J local epochs per user, one quantized N-user weight
upload through the packed wire (`radio.send_stacked`: one pass, one
packet per (user, tensor), one kernel launch on the card), FedAvg
(Eq. 3; coordinate-median option), broadcast back. Bounded-ARQ
erasures and the quorum rule are handled as in the JAX package. Privacy
capture (`capture=True`) records each sync's received weight deltas off
the same stacked payload the average uses, so capturing never perturbs
the trajectory.

Beyond-paper hooks of the JAX package's extension study: custom shards
(`shards=`, e.g. Dirichlet non-IID), FedProx's proximal pull
(`prox_mu`), DP-FedAvg uploads (`dp_sigma`, `dp_clip`: one packed-wire
pass per user, core/dp.py) and sample-with-replacement batching for
shards smaller than one batch.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig
from repro_torch.core import dp
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


def fl_local_phase(train_states, batch, key, lr, prox_mu: float = 0.0,
                   anchor=None):
    """The FL round's local phase (Alg. 1 lines 3-7) for ONE group of
    users: J local steps per user from the group's stacked TrainState.
    Batch leaves are [N, J, B, ...] tensors on the states' device. The
    tiny model's local step draws nothing, so `key` is unused; it keeps
    the JAX package's signature for a step that draws.
    `PopulationScheme` drives heterogeneous FL sub-populations through
    this same body."""
    del key
    if prox_mu:
        local_step = make_local_step_tiny(
            CFG, None, lr, MOMENTUM, prox_mu=prox_mu,
            anchor={"model": anchor, "codec": {}})
    else:
        local_step = _local_step(lr)
    return FED.local_steps_vmapped(local_step, train_states, batch)


def fl_upload(radio, key, user_params):
    """The FL round's quantized sync upload (Alg. 1 lines 8-11): a
    group's whole stacked model through ONE packed-wire pass (one K1
    launch on the card) on the group's own Radio, drawn on
    key.fold_in(999). The Delivery carries the per-user split."""
    return radio.send_stacked(key.fold_in(SYNC_KEY_FOLD).draws(),
                              user_params)


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


class FederatedScheme:
    mode = "fl"

    def __init__(self, wcfg=None, capture: bool = False, shards=None,
                 dp_sigma: float = 0.0, dp_clip: float = 1.0,
                 prox_mu: float = 0.0,
                 sample_with_replacement: bool = False,
                 quorum: float = 0.0, device="cuda", key=Key):
        if capture and dp_sigma > 0:
            # the DP sync sends privatized deltas through its own
            # per-user path and takes no observations
            raise ValueError("capture=True is not supported with "
                             "dp_sigma > 0 (DP uploads are not observed)")
        self.wcfg = wcfg or WirelessConfig(mode="fl")
        self.aggregate = FED.aggregator(self.wcfg.aggregate)
        self.device = resolve_device(device)
        self.key = key              # seed -> root Key (the draw seam)
        self.quorum = float(quorum)
        self.radio = Radio.from_wcfg(self.wcfg)
        # custom shards define the population; wcfg.n_users otherwise
        self.n_users = len(shards) if shards is not None \
            else self.wcfg.n_users
        self.local_epochs = self.wcfg.local_steps
        self.epochs_per_cycle = self.local_epochs
        self.bits_normalizer = float(self.n_users)   # report per-user bits
        self.capture = capture
        self.captures = {"deltas": [], "targets": []} if capture else {}
        self.shards = shards
        self.dp_sigma, self.dp_clip = dp_sigma, dp_clip
        self.prox_mu = prox_mu
        self.sample_with_replacement = sample_with_replacement
        self.last_epsilon = math.inf

    # ------------------------------------------------------------- setup
    def init(self, seed: int, xtr, ytr):
        shards = self.shards if self.shards is not None else \
            partition_users(xtr, ytr, self.n_users)
        spe = len(shards[0][0]) // BATCH
        self._spe = max(1, spe) if self.sample_with_replacement else spe
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
            if self.sample_with_replacement:
                # Dirichlet shards can be smaller than one batch
                for bi in range(j):
                    idx = rng.integers(0, len(xu), BATCH)
                    toks[u, bi] = xu[idx]
                    labs[u, bi] = yu[idx]
            else:
                toks[u], labs[u] = draw_local_epochs(
                    xu, yu, self.local_epochs, rng)
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
        states, metrics = fl_local_phase(state.train, tb, key, lr,
                                         self.prox_mu, broadcast)
        # --- quantized channel upload + aggregation (lines 8-17)
        user_params = states.trainable["model"]
        kch = key.fold_in(SYNC_KEY_FOLD)
        fmetrics, extra = {}, {}
        if self.dp_sigma > 0:
            synced, bits, self.last_epsilon = dp.fedavg_dp_through_channel(
                kch, user_params, broadcast, self.wcfg,
                clip_c=self.dp_clip, sigma=self.dp_sigma)
            # the DP uploads surface no per-packet diagnostics: bill the
            # analytic expected transmissions, as the JAX package does
            n_tx = (self.n_users * len(tree_leaves(user_params))
                    * self.radio.expected_tx())
            bits, energy = float(bits), self.radio.energy_j(bits)
        else:
            dlv = fl_upload(self.radio, key, user_params)
            if self.capture:
                fl_capture(self.captures, dlv.payload, broadcast,
                           [batch["tokens"][u]
                            for u in range(self.n_users)])
            # users whose upload was erased (bounded ARQ) carry zero
            # weight; below quorum the sync is abandoned and everyone
            # re-anchors on the cycle's broadcast weights
            erased = dlv.user_erased or (False,) * self.n_users
            kept = [u for u in range(self.n_users) if not erased[u]]
            need = max(1, math.ceil(self.quorum * self.n_users))
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
            avg = broadcast if rx is None else tree_map(self.aggregate, rx)
            synced = FED.replicate_for_users(avg, self.n_users)   # Eq. 4
            bits, n_tx, energy = dlv.bits, dlv.n_tx, dlv.energy_j
            extra = dict(erased_bits=dlv.erased_bits,
                         outage_s=dlv.outage_s)
        new_train = TrainState(dict(states.trainable, model=synced),
                               states.opt_state, states.step)
        new = SchemeState(new_train, state.data, state.steps + j,
                          state.epoch + self.local_epochs)
        loss = float(metrics["loss"].cpu().numpy().mean())
        return new, RoundReport(loss=loss, steps=j, bits=bits, n_tx=n_tx,
                                energy_j=energy, metrics=fmetrics, **extra)

    # -------------------------------------------------------------- eval
    def evaluate(self, state, xte, yte) -> float:
        gp = tree_map(lambda p: p[0], state.train.trainable["model"])
        return evaluate(gp, xte, yte)[0]

    def flops(self, steps_total: int):
        # full-model fwd+bwd per local step, per user; server only avgs
        return step_flops("cl") * steps_total, 0.0
