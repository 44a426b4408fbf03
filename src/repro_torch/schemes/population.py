"""Heterogeneous client fleets: per-client `Radio`, mixed CL/FL/SL
aggregation and fleet dynamics behind one `Experiment` — the port of
`repro/schemes/population.py`.

    base = WirelessConfig(quant_bits=8)
    clients = [ClientSpec.fl(base, snr_db=20.0),
               ClientSpec.fl(base, snr_db=6.0, quant_bits=4),
               ClientSpec.sl(base, snr_db=12.0, quant_bits=16),
               ClientSpec.cl(base, snr_db=18.0)]
    scheme = build_scheme(base, clients=clients,
                          policy=ParticipationPolicy.uniform(2),
                          deadline_s=120.0)
    res = Experiment(scheme, cycles=7).run()

One round:

0. the `ParticipationPolicy` draws the active subset on its own stream
   (`key(seed + 5).fold_in(cycle)`); the deadline model estimates each
   active radio-bearing client's round time (compute + payload / link
   rate) and drops stragglers over `deadline_s` (with
   `deadline_jitter_sigma` > 0 the compute term carries a lognormal
   multiplier drawn on that stream's fold 909); a `FaultPlan` then
   fells survivors with outages and mid-round dropouts. Sampled-out and
   straggling clients bill zero; fault casualties bill what they burned;
1. each FL group (clients sharing (radio, steps per round)) runs its J
   local epochs from the global model and uploads through ITS radio in
   one stacked pass (`fl_local_phase` / `fl_upload`: one K1 launch per
   group on the card); group 0 draws on the round key, group gi on
   its fold 101 + gi;
2. each active SL client runs one fused split cycle on `key(seed +
   2)` (client si > 0: its fold 201 + si), both legs through its own
   radio at its own quantizer (K1 twice a step on the card), billed by
   replaying the drawn ARQ counts (`sl_cycle_drawn_diag`);
3. each active CL member trains server-side on its shard, which crossed
   its radio ONCE at `init` (billed there; key(seed + 7), member ci > 0
   its fold 500 + ci);
4. sample-count-weighted FedAvg over the round's participants
   (`aggregate_weighted`), the SL codec over the SL participants only;
   below `quorum` the round is abandoned. Everyone re-anchors on the new
   global model (the downlink broadcast is unbilled).

Every crossing lands in one `RoundReport` whose `clients` tuple holds a
`ClientReport` per client. The SL eval (`evaluate_sl`) runs K3 and K4
once per eval slice on the card. Billing rules: docs/ACCOUNTING.md.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig
from repro_torch.core import federated as FED
from repro_torch.core.draws import Key
from repro_torch.nn import resolve_device, tree_leaves, tree_map
from repro_torch.runtime.train_step import TrainState, init_train_state
from repro_torch.schemes.base import (BATCH, CFG, MOMENTUM, ClientReport,
                                      RoundReport, SchemeState, batches_of,
                                      evaluate, step_flops, train_cycle,
                                      user_side_flops_sl)
from repro_torch.schemes.centralized import UPLOAD_STREAM, cl_train_step
from repro_torch.schemes.faults import FaultPlan
from repro_torch.schemes.federated import (draw_local_epochs, fl_capture,
                                           fl_local_phase, fl_upload)
from repro_torch.schemes.radio import Delivery, Radio
from repro_torch.schemes.split import (CAPTURE_FOLD, evaluate_sl,
                                       sl_bits_per_step, sl_cycle,
                                       sl_cycle_drawn_diag, sl_observe,
                                       sl_train_step)

POLICY_STREAM = 5     # participation and deadline jitter: key(seed + 5)
JITTER_FOLD = 909
SL_STREAM = 2         # SL and CL clients' cycle keys: key(seed + 2)
FL_GROUP_FOLD, SL_CLIENT_FOLD, CL_CLIENT_FOLD, CL_UPLOAD_FOLD = \
    101, 201, 301, 500


@dataclasses.dataclass(frozen=True)
class ParticipationPolicy:
    """Which clients take part in a round: `full()` (every client, no
    draw), `uniform(k)` (k clients without replacement) or
    `bernoulli(p)` (each client independently; a round can be empty)."""
    kind: str = "full"
    k: int = 0
    p: float = 1.0

    @classmethod
    def full(cls) -> "ParticipationPolicy":
        return cls("full")

    @classmethod
    def uniform(cls, k: int) -> "ParticipationPolicy":
        return cls("uniform", k=int(k))

    @classmethod
    def bernoulli(cls, p: float) -> "ParticipationPolicy":
        return cls("bernoulli", p=float(p))

    def validate(self, n_clients: int) -> None:
        if self.kind not in ("full", "uniform", "bernoulli"):
            raise ValueError(f"unknown participation kind {self.kind!r}")
        if self.kind == "uniform" and not 1 <= self.k <= n_clients:
            raise ValueError(
                f"uniform-k sampling needs 1 <= k <= {n_clients} "
                f"clients, got k={self.k}")
        if self.kind == "bernoulli" and not 0.0 < self.p <= 1.0:
            raise ValueError(
                f"bernoulli sampling needs 0 < p <= 1, got p={self.p}")

    def active(self, key, n: int) -> np.ndarray:
        """[n] bool participation mask for one round, drawn on `key`'s
        "participation" stream."""
        if self.kind == "full":
            return np.ones(n, bool)
        d = key.draws()
        if self.kind == "uniform":
            mask = np.zeros(n, bool)
            mask[d.choice("participation", n, self.k).numpy()] = True
            return mask
        return d.bernoulli("participation", self.p, (n,)).numpy()


@dataclasses.dataclass(frozen=True, eq=False)
class ClientSpec:
    """One device of a population: its paradigm, its own channel (a
    per-client `WirelessConfig`), its local-epoch count, its data shard
    (explicit arrays, an `n_samples` slice of the corpus, or 0 = an
    equal share) and its compute class (`compute_s_per_step`, seconds
    per optimizer step, the deadline model's compute term). Build with
    `fl` / `sl` / `cl`: keyword overrides are WirelessConfig fields
    applied on top of the shared base config."""
    paradigm: str
    wcfg: WirelessConfig
    local_epochs: int = 1
    n_samples: int = 0
    name: str = ""
    shard: Optional[tuple] = None
    compute_s_per_step: float = 0.0

    @property
    def radio(self) -> Radio:
        return Radio.from_wcfg(self.wcfg)

    @classmethod
    def fl(cls, base: Optional[WirelessConfig] = None, local_epochs: int = 0,
           n_samples: int = 0, name: str = "", shard=None,
           compute_s_per_step: float = 0.0, **overrides) -> "ClientSpec":
        wcfg = dataclasses.replace(base or WirelessConfig(mode="fl"),
                                   mode="fl", **overrides)
        return cls("fl", wcfg, local_epochs or wcfg.local_steps,
                   n_samples, name, shard, compute_s_per_step)

    @classmethod
    def sl(cls, base: Optional[WirelessConfig] = None,
           local_epochs: int = 1, n_samples: int = 0, name: str = "",
           shard=None, compute_s_per_step: float = 0.0,
           **overrides) -> "ClientSpec":
        wcfg = dataclasses.replace(
            base or WirelessConfig(mode="sl", quant_bits=16),
            mode="sl", **overrides)
        return cls("sl", wcfg, local_epochs, n_samples, name, shard,
                   compute_s_per_step)

    @classmethod
    def cl(cls, base: Optional[WirelessConfig] = None,
           local_epochs: int = 1, n_samples: int = 0, name: str = "",
           shard=None, compute_s_per_step: float = 0.0,
           **overrides) -> "ClientSpec":
        """A raw-upload member: its corpus crosses its radio ONCE at
        init, then it is trained server-side every round it takes part
        in; no round radio traffic, so no deadline applies to it."""
        wcfg = dataclasses.replace(base or WirelessConfig(mode="cl"),
                                   mode="cl", **overrides)
        return cls("cl", wcfg, local_epochs, n_samples, name, shard,
                   compute_s_per_step)


def aggregate_weighted(trees, weights):
    """Sample-count-weighted FedAvg of per-client trees, the mixed
    aggregation rule shared by `PopulationScheme` and the fleet engine.
    Equal weights: `mean_users` (bit for bit the port's FL FedAvg).
    Unequal weights: normalized in float64, rounded to float32 and
    divided by their float32 sum as the JAX package does, then summed
    over clients in ascending order in float32, each product rounded
    before its add (the JAX package contracts with one dot, whose order
    XLA picks: within a few float32 ulps of this sum)."""
    weights = np.asarray(weights, np.float64)
    if np.all(weights == weights[0]):
        return tree_map(lambda *ls: FED.mean_users(torch.stack(ls)), *trees)
    w = (torch.from_numpy(weights.astype(np.float32))
         / torch.tensor(float(np.sum(weights)), dtype=torch.float32))

    def contract(*ls):
        wd = w.to(ls[0].device)
        acc = wd[0] * ls[0].float()
        for u in range(1, len(ls)):
            acc = acc + wd[u] * ls[u].float()
        return acc.to(ls[0].dtype)
    return tree_map(contract, *trees)


def select_users(state, idx):
    """The users `idx` (a 1-D tensor) of a user-stacked TrainState."""
    return FED._map_state(lambda a: a[idx.to(a.device)], state)


def merge_users(old, idx, upd):
    """`old` with users `idx` replaced by the stacked state `upd`."""
    return FED._map_state(lambda o, n: o.index_copy(0, idx.to(o.device), n),
                          old, upd)


@dataclasses.dataclass(frozen=True)
class _Group:
    """FL clients sharing (radio, steps per round): one local phase and
    one stacked upload per round."""
    radio: Radio
    members: tuple                    # client indices, population order


@dataclasses.dataclass
class _PopState:
    """Per-round population state (rides SchemeState.train); every leaf,
    the step counters among them, goes into an experiment snapshot."""
    groups: list                      # per _Group: user-stacked TrainState
    sl_states: list                   # per SL client: TrainState
    sl_steps: list                    # per SL client: cumulative steps
    global_trainable: dict            # aggregated {"model", "codec"}
    client_steps: list                # cumulative optimizer steps each
    cl_states: list                   # per CL member: TrainState
    cl_steps: list                    # per CL member: cumulative steps


class PopulationScheme:
    """A heterogeneous client fleet behind the Scheme protocol (see the
    module docstring). Runs on the card unless `device="cpu"`; `key`
    maps a seed to a root `Key` (the draw seam)."""
    mode = "population"

    def __init__(self, wcfg=None, clients: Sequence[ClientSpec] = (),
                 capture: bool = False, capture_every: int = 8,
                 policy: Optional[ParticipationPolicy] = None,
                 deadline_s: Optional[float] = None,
                 deadline_jitter_sigma: float = 0.0,
                 perfect_eval: bool = False,
                 quorum: float = 0.0,
                 fault_plan: Optional[FaultPlan] = None,
                 device="cuda", key=Key):
        if not clients:
            raise ValueError("PopulationScheme needs at least one "
                             "ClientSpec")
        for spec in clients:
            if spec.paradigm not in ("fl", "sl", "cl"):
                raise ValueError(f"unknown paradigm {spec.paradigm!r}")
        self.wcfg = wcfg or WirelessConfig(mode="fl")
        for cfg in [self.wcfg] + [s.wcfg for s in clients]:
            if getattr(cfg, "aggregate", "mean") != "mean":
                raise ValueError(
                    "population aggregation is sample-weighted FedAvg; "
                    "aggregate='median' is not supported (base or "
                    "per-client override)")
        self.device = resolve_device(device)
        self.key = key
        self.clients = tuple(clients)
        self.policy = policy or ParticipationPolicy.full()
        self.policy.validate(len(self.clients))
        self.deadline_s = deadline_s
        if deadline_jitter_sigma < 0.0:
            raise ValueError("deadline_jitter_sigma must be >= 0, got "
                             f"{deadline_jitter_sigma}")
        if deadline_jitter_sigma > 0.0 and deadline_s is None:
            raise ValueError("deadline_jitter_sigma jitters the straggler "
                             "model's compute estimate — it needs a "
                             "deadline_s to act on")
        self.deadline_jitter_sigma = float(deadline_jitter_sigma)
        if not 0.0 <= quorum <= 1.0:
            raise ValueError(f"quorum must be in [0, 1], got {quorum}")
        self.quorum = float(quorum)
        self.fault_plan = fault_plan
        # fault metrics ride RoundReport.metrics only when some fault
        # machinery is on (fault-free fleets keep the plain metrics)
        self._faults_on = (self.quorum > 0.0
                           or (fault_plan is not None and fault_plan.active)
                           or any(s.radio.arq_max_tx > 0
                                  for s in self.clients))
        self.perfect_eval = perfect_eval
        self.radio = Radio.from_wcfg(self.wcfg)
        self._sl_idx = [i for i, s in enumerate(self.clients)
                        if s.paradigm == "sl"]
        self._fl_idx = [i for i, s in enumerate(self.clients)
                        if s.paradigm == "fl"]
        self._cl_idx = [i for i, s in enumerate(self.clients)
                        if s.paradigm == "cl"]
        cfs = {self.clients[i].wcfg.compress_factor for i in self._sl_idx}
        if len(cfs) > 1:
            raise ValueError("SL clients must share compress_factor "
                             f"(one codec shape), got {sorted(cfs)}")
        # the SL eval runs the real channel at the fleet's highest-
        # fidelity SL link, whatever the order of the SL clients
        self._sl_wcfg = (dataclasses.replace(
            self.clients[self._sl_idx[0]].wcfg,
            quant_bits=max(self.clients[i].wcfg.quant_bits
                           for i in self._sl_idx),
            snr_db=max(self.clients[i].wcfg.snr_db for i in self._sl_idx))
            if self._sl_idx else None)
        self.epochs_per_cycle = max(s.local_epochs for s in self.clients)
        # pure-FL fleets report per-user bits (the paper's tables); SL-
        # and CL-bearing ones total system bits
        self.bits_normalizer = (float(len(self.clients))
                                if not self._sl_idx and not self._cl_idx
                                else 1.0)
        self.capture = capture
        self.capture_every = capture_every
        self.captures: dict = {}
        self._key_ctx = None
        self._est_round_s: Optional[list] = None
        self._final_client_steps = [0] * len(self.clients)

    # ------------------------------------------------------------- setup
    def _shards_for(self, xtr, ytr):
        """Shards in population order: an explicit `spec.shard` wins;
        otherwise sequential `n_samples` slices, with n_samples=0
        clients splitting the remainder equally."""
        claimed = sum(s.n_samples for s in self.clients
                      if s.shard is None)
        n_default = sum(1 for s in self.clients
                        if s.shard is None and not s.n_samples)
        default = (len(xtr) - claimed) // n_default if n_default else 0
        if default < 0:
            default = 0
        shards, cursor = [], 0
        for spec in self.clients:
            if spec.shard is not None:
                shards.append((np.asarray(spec.shard[0]),
                               np.asarray(spec.shard[1])))
                continue
            n = spec.n_samples or default
            if cursor + n > len(xtr):
                raise ValueError(f"client shards exceed the corpus "
                                 f"({cursor + n} > {len(xtr)})")
            shards.append((xtr[cursor:cursor + n], ytr[cursor:cursor + n]))
            cursor += n
        for spec, (xs, _) in zip(self.clients, shards):
            if len(xs) < BATCH:
                raise ValueError(
                    f"client {spec.name or spec.paradigm!r} shard has "
                    f"{len(xs)} samples < one batch ({BATCH})")
        return shards

    def _estimate_terms(self, i: int):
        """(compute seconds, comm seconds) of client i's round: steps x
        compute_s_per_step, and its expected round payload over its
        expected link rate. (0, 0) for CL members (no deadline)."""
        spec = self.clients[i]
        if spec.paradigm == "cl":
            return 0.0, 0.0
        steps = spec.local_epochs * self._spe[i]
        comp = steps * spec.compute_s_per_step
        return comp, self._round_bits_estimate(i) / spec.radio.rate_bps()

    def _round_bits_estimate(self, i: int) -> float:
        """Client i's EXPECTED round payload in bits: the deadline
        model's numerator and what a FaultPlan casualty bills (all of it
        for an outage, `frac` of it for a mid-round death)."""
        spec = self.clients[i]
        radio = spec.radio
        steps = spec.local_epochs * self._spe[i]
        if spec.paradigm == "fl":
            return (float(self._model_elems) * radio.quant_bits
                    * radio.expected_tx())
        if spec.paradigm == "sl":
            return (steps * sl_bits_per_step(spec.wcfg, radio.quant_bits)
                    * radio.expected_tx())
        return 0.0

    def estimated_round_s(self, i: int) -> float:
        """Client i's deterministic round-time estimate (after init)."""
        if self._est_round_s is None:
            raise RuntimeError("estimated_round_s needs init() first "
                               "(shard sizes fix the steps per round)")
        return self._est_round_s[i]

    def init(self, seed: int, xtr, ytr):
        xtr, ytr = np.asarray(xtr), np.asarray(ytr)
        shards = self._shards_for(xtr, ytr)
        self._spe = [len(xs) // BATCH for xs, _ in shards]
        if self.capture:
            self.captures = {"deltas": [], "targets": [], "smashed": [],
                             "original": [], "cl_received": [],
                             "cl_original": []}
        groups, by_key = [], {}
        for i in self._fl_idx:
            spec = self.clients[i]
            gk = (spec.radio, spec.local_epochs * self._spe[i])
            if gk not in by_key:
                by_key[gk] = len(groups)
                groups.append([])
            groups[by_key[gk]].append(i)
        self._groups = [_Group(self.clients[m[0]].radio, tuple(m))
                        for m in groups]

        # the model from the same seeded generator as the pure schemes;
        # the codec (SL present only) after it
        fl_full = init_train_state(torch.Generator().manual_seed(seed),
                                   CFG, None, "sgd", MOMENTUM, self.device)
        if self._sl_idx:
            sl_full = init_train_state(torch.Generator().manual_seed(seed),
                                       CFG, self._sl_wcfg, "sgd", MOMENTUM,
                                       self.device)
        self._model_elems = sum(int(l.numel()) for l in
                                tree_leaves(fl_full.trainable["model"]))
        self._est_terms = [self._estimate_terms(i)
                           for i in range(len(self.clients))]
        self._est_round_s = [comp + comm for comp, comm in self._est_terms]

        # CL members: the raw corpus crosses each member's own radio once,
        # billed here; the server trains on what arrived
        init_dlv = None
        if self._cl_idx:
            k7 = self.key(seed + UPLOAD_STREAM)
            bits = energy = n_tx = 0.0
            for ci, i in enumerate(self._cl_idx):
                kc = k7 if ci == 0 else k7.fold_in(CL_UPLOAD_FOLD + ci)
                xs, ys = shards[i]
                dlv = self.clients[i].radio.send_tokens(
                    kc.draws(), torch.from_numpy(np.asarray(xs)).to(
                        self.device), CFG.vocab_size,
                    labels=torch.from_numpy(np.asarray(ys)))
                rx = dlv.payload.cpu().numpy()
                if self.capture:
                    self.captures["cl_received"].append(rx.copy())
                    self.captures["cl_original"].append(
                        np.asarray(xs).copy())
                shards[i] = (rx, np.asarray(ys))
                bits += dlv.bits
                energy += dlv.energy_j
                n_tx += dlv.n_tx
            init_dlv = Delivery(None, bits, energy, n_tx)

        group_states = [FED.broadcast_state(fl_full, len(g.members))
                        for g in self._groups]
        sl_states = [sl_full for _ in self._sl_idx]
        cl_states = [fl_full for _ in self._cl_idx]
        glob = {"model": fl_full.trainable["model"],
                "codec": (sl_full.trainable["codec"] if self._sl_idx
                          else {})}
        pop = _PopState(group_states, sl_states, [0] * len(self._sl_idx),
                        glob, [0] * len(self.clients), cl_states,
                        [0] * len(self._cl_idx))
        return SchemeState(train=pop, data=shards), init_dlv

    def cycle_batches(self, state, rng, cycle):
        """Per-client cycle data in population order from the ONE
        experiment rng, for every client, participant or not (so the
        stream does not depend on the round's sampling)."""
        out = []
        for i, spec in enumerate(self.clients):
            xu, yu = state.data[i]
            if spec.paradigm == "fl":
                toks, labs = draw_local_epochs(xu, yu, spec.local_epochs,
                                               rng)
                out.append({"tokens": toks, "labels": labs})
            else:
                bs = []
                for _ in range(spec.local_epochs):
                    bs.extend(batches_of(xu, yu, BATCH, rng, self.device))
                out.append(bs)
        return out

    def round_key(self, seed: int, cycle: int):
        # the FL stream (group 0's); round() derives the SL / CL and the
        # participation streams from the (seed, cycle) kept here
        self._key_ctx = (seed, cycle)
        return self.key(seed + 3).fold_in(cycle)

    # --------------------------------------------------- fleet dynamics
    def _round_estimates(self, seed: int, cycle: int) -> list:
        """The round's per-client time estimates; with jitter, the
        compute term times exp(sigma z), z ~ N(0, 1) per (client, round)
        from `key(seed + 5).fold_in(cycle).fold_in(909)`."""
        if self.deadline_s is None or self.deadline_jitter_sigma == 0.0:
            return list(self._est_round_s)
        jk = self.key(seed + POLICY_STREAM).fold_in(cycle).fold_in(
            JITTER_FOLD)
        z = jk.draws().normal("jitter", (len(self.clients),)).numpy()
        mult = np.exp(self.deadline_jitter_sigma * z)
        return [comp * float(mult[i]) + comm
                for i, (comp, comm) in enumerate(self._est_terms)]

    def _participants(self, seed: int, cycle: int):
        """(mask, status, estimates, drop fractions): the policy samples,
        the deadline drops stragglers, the FaultPlan fells survivors."""
        n = len(self.clients)
        status = ["ok"] * n
        drop_frac = np.full(n, np.nan)
        if self.policy.kind == "full":
            part = np.ones(n, bool)     # no policy draw at all
        else:
            pk = self.key(seed + POLICY_STREAM).fold_in(cycle)
            part = np.asarray(self.policy.active(pk, n)).copy()
            for i in range(n):
                if not part[i]:
                    status[i] = "sampled_out"
        est = self._round_estimates(seed, cycle)
        if self.deadline_s is not None:
            for i in range(n):
                if (part[i] and self.clients[i].paradigm in ("fl", "sl")
                        and est[i] > self.deadline_s):
                    part[i] = False
                    status[i] = "straggler"
        if self.fault_plan is not None and self.fault_plan.active:
            out, frac = self.fault_plan.events(cycle, n)
            for i in range(n):
                if not part[i]:
                    continue
                if out[i]:
                    part[i] = False
                    status[i] = "erased"
                elif not np.isnan(frac[i]):
                    part[i] = False
                    status[i] = "dropped_midround"
                    drop_frac[i] = frac[i]
        return part, status, est, drop_frac

    # ------------------------------------------------------------- round
    def _sl_capture_cb(self, si: int):
        """What the server receives on SL client si's uplink, sent again
        on the step key's fold 12345 (no training stream moves)."""
        wcfg = self.clients[self._sl_idx[si]].wcfg

        def cb(steps, st, b, kb):
            if steps % self.capture_every == 0:
                z = sl_observe(st.trainable, b["tokens"],
                               kb.fold_in(CAPTURE_FOLD), wcfg)
                self.captures["smashed"].append(z.cpu().numpy())
                self.captures["original"].append(b["tokens"].cpu().numpy())
        return cb

    def round(self, state, batch, key, lr):
        if self._key_ctx is None:
            raise RuntimeError("call round_key(seed, cycle) before "
                               "round(): the SL/CL clients' key streams "
                               "are derived from it (Experiment does "
                               "this)")
        seed, cycle = self._key_ctx
        pop: _PopState = state.train
        n = len(self.clients)
        dev = self.device
        sizes = np.asarray([len(xs) for xs, _ in state.data], np.float64)
        weights = sizes / sizes.sum()
        part, status, est_s, drop_frac = self._participants(seed, cycle)
        outage_s = 0.0
        models = [None] * n
        reports: list = [None] * n
        new_groups, new_sl, new_sl_steps = [], [], []
        new_cl, new_cl_steps = [], []
        client_steps = list(pop.client_steps)
        broadcast = pop.global_trainable["model"]

        # --- FL groups: local phase + one stacked upload each; a
        # partially sampled group trains and uploads its active slice,
        # the others keep their optimizer state
        for gi, group in enumerate(self._groups):
            gk = key if gi == 0 else key.fold_in(FL_GROUP_FOLD + gi)
            sel = [u for u, i in enumerate(group.members) if part[i]]
            if not sel:
                new_groups.append(pop.groups[gi])
                continue
            whole = len(sel) == len(group.members)
            idx = torch.as_tensor(sel)
            mem = [group.members[u] for u in sel]
            gstate = pop.groups[gi] if whole else \
                select_users(pop.groups[gi], idx)
            gb = {k: torch.from_numpy(np.stack([batch[i][k] for i in mem]))
                  .to(dev) for k in ("tokens", "labels")}
            states, metrics = fl_local_phase(gstate, gb, gk, lr)
            dlv = fl_upload(group.radio, gk, states.trainable["model"])
            if self.capture:
                fl_capture(self.captures, dlv.payload, broadcast,
                           [batch[i]["tokens"] for i in mem])
            losses = metrics["loss"].cpu().numpy()          # [N_a, J]
            outage_s += dlv.outage_s
            ue = dlv.user_erased or (False,) * len(mem)
            ueb = dlv.user_erased_bits or (0.0,) * len(mem)
            for u, i in enumerate(mem):
                if ue[u]:
                    # trained, but its upload did not survive the bounded
                    # ARQ link: zero weight, the attempt billed
                    status[i] = "erased"
                else:
                    models[i] = tree_map(lambda p, u=u: p[u], dlv.payload)
                j = losses.shape[1]
                client_steps[i] += j
                reports[i] = ClientReport(
                    name=self.clients[i].name or f"fl{i}", paradigm="fl",
                    loss=float(losses[u].mean()), steps=j,
                    bits=dlv.user_bits[u], n_tx=dlv.user_n_tx[u],
                    energy_j=group.radio.energy_j(dlv.user_bits[u]),
                    status=status[i], est_round_s=est_s[i],
                    erased_bits=ueb[u])
            new_groups.append(states if whole else
                              merge_users(pop.groups[gi], idx, states))

        # --- SL clients: one fused split cycle each, own radio/quantizer
        sl_base = self.key(seed + SL_STREAM)
        for si, i in enumerate(self._sl_idx):
            spec = self.clients[i]
            sk = sl_base if si == 0 else sl_base.fold_in(SL_CLIENT_FOLD + si)
            if not part[i]:
                new_sl.append(pop.sl_states[si])
                new_sl_steps.append(pop.sl_steps[si])
                continue
            st, m, steps = sl_cycle(
                sl_train_step(spec.wcfg, lr), pop.sl_states[si], batch[i],
                sk, pop.sl_steps[si],
                on_step=self._sl_capture_cb(si) if self.capture else None)
            n_steps = steps - pop.sl_steps[si]
            radio = spec.radio
            n_tx, n_er, bo = sl_cycle_drawn_diag(sk, pop.sl_steps[si],
                                                 n_steps, radio)
            leg_bits = sl_bits_per_step(spec.wcfg, radio.quant_bits) / 2.0
            bits = n_tx * leg_bits
            outage_s += bo * radio.arq_backoff_s
            # an erased SL leg arrives as zeros inside the step: the
            # client stays a participant, its wasted air time is billed
            models[i] = st.trainable["model"]
            client_steps[i] += n_steps
            reports[i] = ClientReport(
                name=spec.name or f"sl{i}", paradigm="sl",
                loss=float(m["loss"]), steps=n_steps, bits=bits,
                n_tx=n_tx, energy_j=radio.energy_j(bits),
                est_round_s=est_s[i],
                erased_bits=n_er * radio.arq_max_tx * leg_bits)
            new_sl.append(st)
            new_sl_steps.append(steps)

        # --- CL members: server-side epochs over the received shard
        cl_base = self.key(seed + SL_STREAM)
        for ci, i in enumerate(self._cl_idx):
            spec = self.clients[i]
            ck = cl_base.fold_in(CL_CLIENT_FOLD + ci)
            if not part[i]:
                new_cl.append(pop.cl_states[ci])
                new_cl_steps.append(pop.cl_steps[ci])
                continue
            st, m, steps = train_cycle(cl_train_step(lr),
                                       pop.cl_states[ci], batch[i], ck,
                                       pop.cl_steps[ci])
            n_steps = steps - pop.cl_steps[ci]
            models[i] = st.trainable["model"]
            client_steps[i] += n_steps
            reports[i] = ClientReport(
                name=spec.name or f"cl{i}", paradigm="cl",
                loss=float(m["loss"]), steps=n_steps)
            new_cl.append(st)
            new_cl_steps.append(steps)

        # --- clients that sat the round out: zero bills, except FaultPlan
        # casualties (an outage bills its whole expected payload, erased,
        # no energy; a mid-round death `frac` of it, with its energy)
        for i in range(n):
            if reports[i] is None:
                bits = energy = 0.0
                if status[i] == "erased":
                    bits = self._round_bits_estimate(i)
                elif status[i] == "dropped_midround":
                    bits = float(drop_frac[i]) * self._round_bits_estimate(i)
                    energy = self.clients[i].radio.energy_j(bits)
                reports[i] = ClientReport(
                    name=self.clients[i].name
                    or f"{self.clients[i].paradigm}{i}",
                    paradigm=self.clients[i].paradigm, loss=0.0, steps=0,
                    bits=bits, energy_j=energy, status=status[i],
                    est_round_s=est_s[i], erased_bits=bits)

        # --- mixed aggregation over the participants, under the quorum
        trained = [i for i in range(n) if models[i] is not None]
        need = max(1, math.ceil(self.quorum * n))
        quorum_met = len(trained) >= need
        renorm = 1.0 if len(trained) == n else (
            float(weights[np.asarray(trained)].sum()) if trained else 1.0)
        if quorum_met:
            for i in trained:
                reports[i].weight = float(weights[i] / renorm)
            agg_model = aggregate_weighted([models[i] for i in trained],
                                           weights[np.asarray(trained)])
        else:
            agg_model = broadcast      # abandoned round: global unchanged
        sl_trained = [si for si, i in enumerate(self._sl_idx)
                      if models[i] is not None] if quorum_met else []
        if sl_trained:
            agg_codec = aggregate_weighted(
                [new_sl[si].trainable["codec"] for si in sl_trained],
                weights[np.asarray([self._sl_idx[si]
                                    for si in sl_trained])])
        else:
            agg_codec = pop.global_trainable["codec"]

        # --- broadcast back: every client re-anchors on the new global
        new_groups = [
            TrainState(dict(s.trainable, model=FED.replicate_for_users(
                agg_model, len(g.members))), s.opt_state, s.step)
            for g, s in zip(self._groups, new_groups)]
        new_sl = [TrainState({"model": agg_model, "codec": agg_codec},
                             s.opt_state, s.step) for s in new_sl]
        new_cl = [TrainState(dict(s.trainable, model=agg_model),
                             s.opt_state, s.step) for s in new_cl]

        glob = {"model": agg_model, "codec": agg_codec}
        new_pop = _PopState(new_groups, new_sl, new_sl_steps, glob,
                            client_steps, new_cl, new_cl_steps)
        self._final_client_steps = client_steps
        total_steps = sum(r.steps for r in reports)
        new = SchemeState(new_pop, state.data,
                          state.steps + total_steps,
                          state.epoch + self.epochs_per_cycle)
        metrics = {"n_active": len(trained),
                   "n_sampled_out": status.count("sampled_out"),
                   "n_stragglers": status.count("straggler")}
        if self._faults_on:
            metrics.update(n_erased=status.count("erased"),
                           n_dropped_midround=status.count(
                               "dropped_midround"),
                           quorum_met=quorum_met)
        return new, RoundReport(
            loss=float(sum(r.loss * r.weight for r in reports)),
            steps=total_steps,
            bits=float(sum(r.bits for r in reports)),
            n_tx=float(sum(r.n_tx for r in reports)),
            energy_j=float(sum(r.energy_j for r in reports)),
            metrics=metrics,
            clients=tuple(reports),
            erased_bits=float(sum(r.erased_bits for r in reports)),
            outage_s=float(outage_s))

    # -------------------------------------------------------------- eval
    def evaluate(self, state, xte, yte) -> float:
        glob = state.train.global_trainable
        if self._sl_idx:
            # the deployed function includes the trained codec
            return evaluate_sl(glob, self._sl_wcfg, xte, yte, key=self.key,
                               perfect_eval=self.perfect_eval)
        return evaluate(glob["model"], xte, yte)[0]

    def flops(self, steps_total: int):
        """Per-client accounting off the clients' step counters; CL
        members' epochs run server-side (the paper: CL user compute 0)."""
        user = server = 0.0
        for i, spec in enumerate(self.clients):
            steps = self._final_client_steps[i]
            if spec.paradigm == "fl":
                user += step_flops("cl") * steps
            elif spec.paradigm == "cl":
                server += step_flops("cl") * steps
            else:
                cf = spec.wcfg.compress_factor
                u = user_side_flops_sl(cf)
                user += u * steps
                server += (step_flops("sl", cf) - u) * steps
        return user, server
