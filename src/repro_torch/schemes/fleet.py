"""Large fleets: struct-of-arrays populations and streamed aggregate
reports — the port of `repro/schemes/fleet.py`.

`PopulationScheme` (schemes/population.py) walks a list of `ClientSpec`s
and emits a `ClientReport` per client: fine for tens of clients, a wall
at 10^5. This module is the scale engine behind the same Scheme /
Experiment boundary:

* `ClientBatch` — the population as [N] numpy arrays (paradigm codes,
  local epochs, shard sizes, compute class, per-client fault
  probabilities) plus small lookup tables of the unique
  `WirelessConfig`s and `Radio`s (`wcfg_id`, `radio_id`). Build it from
  specs (`from_specs`, the parity fleets) or directly at scale
  (`synthetic`, no per-client Python objects).
* `FleetScheme` — per-round sampling, deadline cuts, `FaultPlan` faults
  and per-client Radio billing over the arrays. Decisions and bills are
  host float64 arithmetic in the loop engine's expression order (totals
  by a left fold, `_seq_sum`), so a fleet bills bit for bit what
  `PopulationScheme` bills on the same specs.

Two planes:

* billing (always; any N, any FL / SL / CL mix): the drawn ARQ counts,
  erasures and backoff are functions of the keys and the link knobs,
  never of the payload, so the round's bill needs no training. Each FL
  group replays its stacked upload's "arq" draw on the same key and
  [n_active, packets] shape the loop's `fl_upload` draws; each SL
  client replays `split.sl_cycle_drawn_diag` on the loop's keys.
* training (`train=`, all-FL fleets up to `train_cap`): also runs the
  real `fl_local_phase` / `fl_upload` on the same keys (one K1 launch
  per group on the card), reproducing the loop's trajectory, while the
  bill still comes from the one replay path. It keeps the JAX
  package's API (`build_scheme(engine="fleet")` on a small all-FL
  fleet lands here); `PopulationScheme` trains the same fleets
  identically and is the engine that trains mixed ones.

The JAX package shards its replays' [clients, ...] draws over a
`clients` mesh axis and vectorises the per-client SL keys. On one card
the `clients` axis has nothing to place (under the one-card test mesh it
resolves to replication, so a fleet bills the same with or without it),
and the port's per-(key, name) generators are opened one client at a
time, so the SL replay is a host loop over the active SL clients
(`last_round_seconds["sl_replay"]` says what it costs).

Reports stream as AGGREGATES: `RoundReport.clients` stays empty and
`metrics["fleet"]` carries count / sum / quantile / histogram summaries
(plus an opt-in top-k spill, `spill_top_k`). The last round's
per-client arrays stay in `last_round_detail` (not checkpointed).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig
from repro_torch.core import federated as FED
from repro_torch.core import wire as W
from repro_torch.core.draws import Key
from repro_torch.nn import resolve_device, tree_leaves, tree_map
from repro_torch.runtime.fl_runtime import SYNC_KEY_FOLD
from repro_torch.runtime.train_step import TrainState, init_train_state
from repro_torch.schemes.base import (BATCH, CFG, MOMENTUM, RoundReport,
                                      SchemeState, evaluate, step_flops,
                                      user_side_flops_sl)
from repro_torch.schemes.centralized import UPLOAD_STREAM
from repro_torch.schemes.faults import FaultPlan
from repro_torch.schemes.federated import (draw_local_epochs, fl_local_phase,
                                           fl_upload)
from repro_torch.schemes.population import (CL_UPLOAD_FOLD, FL_GROUP_FOLD,
                                            POLICY_STREAM, SL_CLIENT_FOLD,
                                            SL_STREAM, JITTER_FOLD,
                                            ClientSpec, ParticipationPolicy,
                                            aggregate_weighted, merge_users,
                                            select_users)
from repro_torch.schemes.radio import Delivery, Radio
from repro_torch.schemes.split import (_wcfg_key, sl_bits_per_step,
                                       sl_cycle_drawn_diag)

# paradigm codes in ClientBatch.paradigm / status codes in the round
# detail; the names are PopulationScheme's ClientReport.status values
PARADIGMS = ("fl", "sl", "cl")
STATUS_NAMES = ("ok", "sampled_out", "straggler", "erased",
                "dropped_midround")
_OK, _SAMPLED_OUT, _STRAGGLER, _ERASED, _DROPPED = range(5)
HIST_BINS = 8           # histogram bins of each streamed summary


# --------------------------------------------------------------- batch
@dataclasses.dataclass(frozen=True)
class ClientBatch:
    """A population as struct-of-arrays ([N] each) plus lookup tables of
    the unique channel configs; the arrays are the only per-client
    state."""
    paradigm: np.ndarray            # [N] int8 codes into PARADIGMS
    local_epochs: np.ndarray        # [N] int32 (J for FL)
    n_samples: np.ndarray           # [N] int64 shard sizes (0 = share)
    compute_s_per_step: np.ndarray  # [N] float64 device compute class
    wcfg_id: np.ndarray             # [N] int32 into `wcfgs`
    radio_id: np.ndarray            # [N] int32 into `radios`
    wcfgs: tuple                    # unique WirelessConfig table
    radios: tuple                   # unique Radio table (eq-deduped)
    # per-client fault probabilities; None = the FaultPlan's scalars
    p_outage: Optional[np.ndarray] = None
    p_dropout: Optional[np.ndarray] = None
    names: Optional[tuple] = None
    shards: Optional[tuple] = None          # explicit (x, y) overrides
    specs: Optional[tuple] = None           # kept for parity fleets

    @property
    def n(self) -> int:
        return int(self.paradigm.shape[0])

    def __len__(self) -> int:
        return self.n

    @property
    def snr_db(self) -> np.ndarray:
        return np.asarray([r.snr_db for r in self.radios],
                          np.float64)[self.radio_id]

    @property
    def quant_bits(self) -> np.ndarray:
        return np.asarray([r.quant_bits for r in self.radios],
                          np.int32)[self.radio_id]

    @classmethod
    def from_specs(cls, specs: Sequence[ClientSpec]) -> "ClientBatch":
        """Columnarize a ClientSpec population: unique configs and Radios
        (by equality, the loop's grouping key) into the tables, the rest
        into arrays."""
        specs = tuple(specs)
        if not specs:
            raise ValueError("ClientBatch.from_specs needs >= 1 spec")
        n = len(specs)
        paradigm = np.empty(n, np.int8)
        local_epochs = np.empty(n, np.int32)
        n_samples = np.empty(n, np.int64)
        compute = np.empty(n, np.float64)
        wcfg_id = np.empty(n, np.int32)
        radio_id = np.empty(n, np.int32)
        wcfgs, wmap, radios, rmap = [], {}, [], {}
        for i, s in enumerate(specs):
            if s.paradigm not in PARADIGMS:
                raise ValueError(f"unknown paradigm {s.paradigm!r}")
            paradigm[i] = PARADIGMS.index(s.paradigm)
            local_epochs[i] = s.local_epochs
            n_samples[i] = s.n_samples
            compute[i] = s.compute_s_per_step
            wk = _wcfg_key(s.wcfg)
            if wk not in wmap:
                wmap[wk] = len(wcfgs)
                wcfgs.append(s.wcfg)
            wcfg_id[i] = wmap[wk]
            r = s.radio
            if r not in rmap:
                rmap[r] = len(radios)
                radios.append(r)
            radio_id[i] = rmap[r]
        return cls(paradigm, local_epochs, n_samples, compute, wcfg_id,
                   radio_id, tuple(wcfgs), tuple(radios),
                   names=tuple(s.name for s in specs),
                   shards=tuple(s.shard for s in specs), specs=specs)

    @classmethod
    def synthetic(cls, n: int, seed: int = 0,
                  snr_classes: Sequence[float] = (4.0, 8.0, 12.0, 20.0),
                  quant_bits: int = 8, local_epochs: int = 1,
                  n_samples: int = BATCH,
                  compute_s_range: tuple = (0.0, 0.0),
                  sl_frac: float = 0.0, fading: bool = True,
                  arq_max_tx: int = 0, arq_backoff_s: float = 0.0,
                  ge_p_gb: float = 0.0,
                  p_outage: float = 0.0,
                  p_dropout: float = 0.0) -> "ClientBatch":
        """An n-client synthetic fleet with no per-client Python objects:
        a few link classes (one Radio per SNR class x paradigm), uniform
        per-client compute, `n_samples` samples per client taken at face
        value (the billing plane never materializes shards). Drawn from
        numpy's generator at `seed`, as in the JAX package."""
        if n < 1:
            raise ValueError(f"synthetic fleet needs n >= 1, got {n}")
        if n_samples < BATCH:
            raise ValueError(f"n_samples must be >= one batch ({BATCH})")
        rng = np.random.default_rng(seed)
        n_sl = int(round(n * float(sl_frac)))
        paradigm = np.zeros(n, np.int8)
        if n_sl:
            paradigm[rng.choice(n, n_sl, replace=False)] = 1
        cls_idx = rng.integers(0, len(snr_classes), n)
        lo, hi = compute_s_range
        compute = (np.full(n, float(lo)) if hi <= lo
                   else rng.uniform(lo, hi, n))
        wcfgs, radios = [], []
        for snr in snr_classes:
            for mode in ("fl", "sl"):
                wcfgs.append(WirelessConfig(
                    mode=mode, snr_db=float(snr),
                    quant_bits=(16 if mode == "sl" else quant_bits),
                    fading=fading, arq_max_tx=arq_max_tx,
                    arq_backoff_s=arq_backoff_s, ge_p_gb=ge_p_gb))
                radios.append(Radio.from_wcfg(wcfgs[-1]))
        wcfg_id = (cls_idx * 2 + paradigm.astype(np.int64)).astype(np.int32)
        pf, pd = float(p_outage), float(p_dropout)
        return cls(paradigm, np.full(n, int(local_epochs), np.int32),
                   np.full(n, int(n_samples), np.int64), compute,
                   wcfg_id, wcfg_id.copy(), tuple(wcfgs), tuple(radios),
                   p_outage=(np.full(n, pf) if pf > 0 else None),
                   p_dropout=(np.full(n, pd) if pd > 0 else None))


# --------------------------------------------------------------- state
@dataclasses.dataclass
class _FleetState:
    """Per-round fleet state (rides SchemeState.train): the aggregated
    global model, the training plane's stacked per-group TrainStates
    ([] on the billing plane) and the cumulative step counters as
    arrays."""
    glob: dict                      # {"model": tree}
    groups: list                    # training plane: stacked TrainState
    client_steps: np.ndarray        # [N] int64 cumulative optimizer steps
    sl_steps: np.ndarray            # [n_sl] int64 cumulative SL steps


def _summary(arr: np.ndarray, bins: int) -> dict:
    """JSON-safe summary of one [N] metric: count, sum, moments,
    quantiles, histogram (plain Python numbers, so it survives a
    snapshot's JSON round trip)."""
    a = np.asarray(arr, np.float64)
    if a.size == 0:
        return {"count": 0, "sum": 0.0}
    qs = np.quantile(a, [0.5, 0.9, 0.99])
    counts, edges = np.histogram(a, bins=bins)
    return {"count": int(a.size), "sum": float(a.sum()),
            "mean": float(a.mean()), "min": float(a.min()),
            "max": float(a.max()), "p50": float(qs[0]),
            "p90": float(qs[1]), "p99": float(qs[2]),
            "hist_counts": [int(c) for c in counts],
            "hist_edges": [float(e) for e in edges]}


def _seq_sum(arr: np.ndarray) -> float:
    """Left fold in index order: the reduction `sum(r.x for r in
    reports)` of the loop engine (np.sum adds pairwise and may differ in
    the last ulp)."""
    return float(sum(arr.tolist()))


def _fault_free(radio: Radio) -> bool:
    return W.fault_free(radio.fading, radio.perfect, radio.arq_attempts,
                        radio.arq_min_f2, radio.arq_max_tx, radio.ge_p_gb)


# -------------------------------------------------------------- scheme
class FleetScheme:
    """`ClientBatch` fleets behind the Scheme protocol (see the module
    docstring for the two planes and the parity contract with
    `PopulationScheme`). Runs on the card unless `device="cpu"`."""
    mode = "fleet"

    def __init__(self, wcfg=None, batch: Optional[ClientBatch] = None,
                 capture: bool = False,
                 policy: Optional[ParticipationPolicy] = None,
                 deadline_s: Optional[float] = None,
                 deadline_jitter_sigma: float = 0.0,
                 quorum: float = 0.0,
                 fault_plan: Optional[FaultPlan] = None,
                 train: str = "auto", train_cap: int = 32,
                 spill_top_k: int = 0, device="cuda", key=Key):
        if batch is None or batch.n == 0:
            raise ValueError("FleetScheme needs a non-empty ClientBatch")
        if capture:
            raise ValueError("privacy capture records per-client "
                             "observations — use PopulationScheme for "
                             "capture fleets")
        self.wcfg = wcfg or WirelessConfig(mode="fl")
        self.batch = batch
        for cfg in (self.wcfg,) + batch.wcfgs:
            if getattr(cfg, "aggregate", "mean") != "mean":
                raise ValueError(
                    "fleet aggregation is sample-weighted FedAvg; "
                    "aggregate='median' is not supported")
        self.device = resolve_device(device)
        self.key = key
        self.policy = policy or ParticipationPolicy.full()
        self.policy.validate(batch.n)
        self.deadline_s = deadline_s
        if deadline_jitter_sigma < 0.0:
            raise ValueError("deadline_jitter_sigma must be >= 0, got "
                             f"{deadline_jitter_sigma}")
        if deadline_jitter_sigma > 0.0 and deadline_s is None:
            raise ValueError("deadline_jitter_sigma needs a deadline_s "
                             "to act on")
        self.deadline_jitter_sigma = float(deadline_jitter_sigma)
        if not 0.0 <= quorum <= 1.0:
            raise ValueError(f"quorum must be in [0, 1], got {quorum}")
        self.quorum = float(quorum)
        # per-client fault probabilities: the batch's arrays win, else
        # the plan's scalars (then `events_arrays` is `events`)
        pl_out = fault_plan.p_outage if fault_plan else 0.0
        pl_drop = fault_plan.p_dropout if fault_plan else 0.0
        self._p_out = (np.asarray(batch.p_outage, np.float64)
                       if batch.p_outage is not None
                       else np.full(batch.n, float(pl_out)))
        self._p_drop = (np.asarray(batch.p_dropout, np.float64)
                        if batch.p_dropout is not None
                        else np.full(batch.n, float(pl_drop)))
        if (batch.p_outage is not None or batch.p_dropout is not None) \
                and fault_plan is None:
            # per-client probabilities still need a seeded stream
            fault_plan = FaultPlan(key=key)
        self.fault_plan = fault_plan
        self._plan_on = fault_plan is not None and (
            bool(np.any(self._p_out > 0.0))
            or bool(np.any(self._p_drop > 0.0)))
        self._faults_on = (self.quorum > 0.0 or self._plan_on
                           or any(r.arq_max_tx > 0 for r in batch.radios))
        self.spill_top_k = int(spill_top_k)
        self.radio = Radio.from_wcfg(self.wcfg)
        self.captures: dict = {}

        self._fl_idx = np.flatnonzero(batch.paradigm == 0)
        self._sl_idx = np.flatnonzero(batch.paradigm == 1)
        self._cl_idx = np.flatnonzero(batch.paradigm == 2)
        sl_cfs = {batch.wcfgs[batch.wcfg_id[i]].compress_factor
                  for i in self._sl_idx}
        if len(sl_cfs) > 1:
            raise ValueError("SL clients must share compress_factor "
                             f"(one codec shape), got {sorted(sl_cfs)}")
        if train not in ("auto", "on", "off"):
            raise ValueError(f"train must be auto|on|off, got {train!r}")
        all_fl = self._sl_idx.size == 0 and self._cl_idx.size == 0
        if train == "on" and not (all_fl and batch.n <= train_cap):
            raise ValueError(
                "the training plane is all-FL fleets up to train_cap="
                f"{train_cap} (got n={batch.n}); larger or mixed fleets "
                "run the billing plane")
        self.train_on = (train == "on"
                         or (train == "auto" and all_fl
                             and batch.n <= train_cap))
        if self._cl_idx.size and batch.specs is None:
            raise ValueError("CL members upload a real corpus at init — "
                             "build the batch via ClientBatch.from_specs")
        self.epochs_per_cycle = int(batch.local_epochs.max())
        self.bits_normalizer = (float(batch.n) if all_fl else 1.0)
        rt, rid = batch.radios, batch.radio_id
        self._rate = np.asarray([r.rate_bps() for r in rt], np.float64)[rid]
        self._tx_power = np.asarray([r.tx_power_w for r in rt],
                                    np.float64)[rid]
        self._exp_tx = np.asarray([r.expected_tx() for r in rt],
                                  np.float64)[rid]
        self._qbits = np.asarray([r.quant_bits for r in rt],
                                 np.float64)[rid]
        self._arq_max = np.asarray([r.arq_max_tx for r in rt],
                                   np.float64)[rid]
        self._arq_backoff = np.asarray([r.arq_backoff_s for r in rt],
                                       np.float64)[rid]
        # per-step SL payload (both legs) at each client's quantizer
        self._sl_step_bits = np.zeros(batch.n, np.float64)
        for i in self._sl_idx:
            wc = batch.wcfgs[batch.wcfg_id[i]]
            self._sl_step_bits[i] = sl_bits_per_step(
                wc, rt[rid[i]].quant_bits)
        self._key_ctx = None
        self._spe: Optional[np.ndarray] = None
        self.last_round_detail: Optional[dict] = None
        self.last_round_seconds: Optional[dict] = None
        self._final_client_steps = np.zeros(batch.n, np.int64)

    # ------------------------------------------------------------ setup
    def _shard_lens(self, n_corpus: int) -> np.ndarray:
        """Per-client shard sizes by `PopulationScheme._shards_for`'s
        rule (explicit shard, then n_samples, then an equal share of the
        rest); the billing plane needs only the sizes."""
        b = self.batch
        explicit = np.zeros(b.n, bool)
        lens = np.asarray(b.n_samples, np.int64).copy()
        if b.shards is not None:
            for i, sh in enumerate(b.shards):
                if sh is not None:
                    explicit[i] = True
                    lens[i] = len(sh[0])
        free = ~explicit
        claimed = int(lens[free].sum())
        n_default = int((free & (lens == 0)).sum())
        default = max((n_corpus - claimed) // n_default, 0) \
            if n_default else 0
        lens[free & (lens == 0)] = default
        if np.any(lens < BATCH):
            i = int(np.argmin(lens))
            raise ValueError(f"client {i} shard has {int(lens[i])} "
                             f"samples < one batch ({BATCH})")
        return lens

    def _materialize_shards(self, xtr, ytr):
        """Real per-client shards (training plane and CL uploads), the
        loop's sequential slices."""
        b = self.batch
        out, cursor = [], 0
        lens = self._shard_lens(len(xtr))
        for i in range(b.n):
            sh = b.shards[i] if b.shards is not None else None
            if sh is not None:
                out.append((np.asarray(sh[0]), np.asarray(sh[1])))
                continue
            n = int(lens[i])
            if cursor + n > len(xtr):
                raise ValueError(f"client shards exceed the corpus "
                                 f"({cursor + n} > {len(xtr)})")
            out.append((xtr[cursor:cursor + n], ytr[cursor:cursor + n]))
            cursor += n
        return out

    def init(self, seed: int, xtr, ytr):
        xtr, ytr = np.asarray(xtr), np.asarray(ytr)
        b = self.batch
        lens = self._shard_lens(len(xtr))
        self._spe = lens // BATCH
        self._steps_round = (b.local_epochs.astype(np.int64)
                             * self._spe).astype(np.int64)
        self._sizes = lens.astype(np.float64)
        self._weights = self._sizes / self._sizes.sum()

        fl_full = init_train_state(torch.Generator().manual_seed(seed),
                                   CFG, None, "sgd", MOMENTUM, self.device)
        model = fl_full.trainable["model"]
        leaves = tree_leaves(model)
        self._model_elems = sum(int(l.numel()) for l in leaves)
        self._leaf_sizes = np.asarray([int(l.numel()) for l in leaves],
                                      np.float64)
        self._n_packets = len(leaves)

        # expected round payload and deadline terms, the loop's order
        is_fl, is_sl, is_cl = (b.paradigm == 0, b.paradigm == 1,
                               b.paradigm == 2)
        steps = self._steps_round.astype(np.float64)
        bits_est = np.zeros(b.n, np.float64)
        bits_est[is_fl] = (float(self._model_elems)
                           * self._qbits[is_fl]) * self._exp_tx[is_fl]
        bits_est[is_sl] = (steps[is_sl] * self._sl_step_bits[is_sl]) \
            * self._exp_tx[is_sl]
        self._bits_est = bits_est
        comp = steps * b.compute_s_per_step
        comp[is_cl] = 0.0
        comm = np.zeros(b.n, np.float64)
        rb = ~is_cl
        comm[rb] = bits_est[rb] / self._rate[rb]
        self._est_comp, self._est_comm = comp, comm
        self._est_round_s = comp + comm

        # FL groups by (radio_id, steps per round), first appearance over
        # the FL indices: the loop's grouping exactly
        groups, by_key = [], {}
        for i in self._fl_idx.tolist():
            gk = (int(b.radio_id[i]), int(self._steps_round[i]))
            if gk not in by_key:
                by_key[gk] = len(groups)
                groups.append([])
            groups[by_key[gk]].append(i)
        self._groups = [(b.radios[b.radio_id[m[0]]],
                         np.asarray(m, np.int64)) for m in groups]
        self._sl_base = self.key(seed + SL_STREAM)

        shards = None
        init_dlv = None
        if self.train_on or self._cl_idx.size:
            shards = self._materialize_shards(xtr, ytr)
        if self._cl_idx.size:
            # CL raw-corpus uploads on the loop's key(seed + 7) stream
            k7 = self.key(seed + UPLOAD_STREAM)
            bits = energy = n_tx = 0.0
            for ci, i in enumerate(self._cl_idx.tolist()):
                radio = b.radios[b.radio_id[i]]
                kc = k7 if ci == 0 else k7.fold_in(CL_UPLOAD_FOLD + ci)
                xs, ys = shards[i]
                dlv = radio.send_tokens(
                    kc.draws(), torch.from_numpy(np.asarray(xs)).to(
                        self.device), CFG.vocab_size,
                    labels=torch.from_numpy(np.asarray(ys)))
                shards[i] = (dlv.payload.cpu().numpy(), np.asarray(ys))
                bits += dlv.bits
                energy += dlv.energy_j
                n_tx += dlv.n_tx
            init_dlv = Delivery(None, bits, energy, n_tx)

        group_states = ([FED.broadcast_state(fl_full, len(mem))
                         for _, mem in self._groups]
                        if self.train_on else [])
        fs = _FleetState({"model": model}, group_states,
                         np.zeros(b.n, np.int64),
                         np.zeros(self._sl_idx.size, np.int64))
        data = shards if self.train_on else None
        return SchemeState(train=fs, data=data), init_dlv

    def cycle_batches(self, state, rng, cycle):
        """Training plane: the loop's per-client draws (all-FL, so
        `draw_local_epochs` per client in population order). Billing
        plane: no data and no rng drawn."""
        if not self.train_on:
            return None
        out = []
        for i in range(self.batch.n):
            xu, yu = state.data[i]
            toks, labs = draw_local_epochs(
                xu, yu, int(self.batch.local_epochs[i]), rng)
            out.append({"tokens": toks, "labels": labs})
        return out

    def round_key(self, seed: int, cycle: int):
        self._key_ctx = (seed, cycle)
        return self.key(seed + 3).fold_in(cycle)

    # -------------------------------------------------- fleet dynamics
    def _round_estimates(self, seed: int, cycle: int) -> np.ndarray:
        """[N] float64 round-time estimates; the loop's lognormal
        compute jitter on the same stream when on (the float32
        multiplier widened to float64, as `float(mult[i])` does)."""
        if self.deadline_s is None or self.deadline_jitter_sigma == 0.0:
            return self._est_round_s.copy()
        jk = self.key(seed + POLICY_STREAM).fold_in(cycle).fold_in(
            JITTER_FOLD)
        z = jk.draws().normal("jitter", (self.batch.n,)).numpy()
        mult = np.exp(self.deadline_jitter_sigma * z)
        return self._est_comp * mult.astype(np.float64) + self._est_comm

    def _participants(self, seed: int, cycle: int):
        """Vectorized `PopulationScheme._participants`: the same streams,
        the same priority, the same gates on drawing at all."""
        n = self.batch.n
        status = np.zeros(n, np.int8)
        drop_frac = np.full(n, np.nan)
        if self.policy.kind == "full":
            part = np.ones(n, bool)
        else:
            pk = self.key(seed + POLICY_STREAM).fold_in(cycle)
            part = np.asarray(self.policy.active(pk, n)).copy()
            status[~part] = _SAMPLED_OUT
        est = self._round_estimates(seed, cycle)
        if self.deadline_s is not None:
            lag = part & (self.batch.paradigm != 2) \
                & (est > self.deadline_s)
            part &= ~lag
            status[lag] = _STRAGGLER
        if self._plan_on:
            out, frac = self.fault_plan.events_arrays(
                cycle, self._p_out, self._p_drop)
            out = out & part
            part &= ~out
            status[out] = _ERASED
            drop = part & ~np.isnan(frac)
            part &= ~drop
            status[drop] = _DROPPED
            drop_frac[drop] = frac[drop]
        return part, status, est, drop_frac

    def _fl_draw(self, radio: Radio, gk, n_a: int):
        """([n_a, P] n_tx, [n_a, P] erased) of one FL group's stacked
        upload: the "arq" draw `fl_upload` makes on gk.fold_in(999)."""
        if _fault_free(radio):
            return (np.ones((n_a, self._n_packets), np.int64),
                    np.zeros((n_a, self._n_packets), bool))
        _, ntx, er = W._packet_fades(
            gk.fold_in(SYNC_KEY_FOLD).draws(), n_a, self._n_packets,
            radio.fading, radio.arq_attempts, radio.arq_min_f2,
            radio.arq_max_tx, radio.ge_p_gb, radio.ge_p_bg)
        return ntx.numpy(), er.numpy()

    # ------------------------------------------------------------ round
    def round(self, state, batch, key, lr):
        if self._key_ctx is None:
            raise RuntimeError("call round_key(seed, cycle) before "
                               "round() (Experiment does this)")
        t_round = time.perf_counter()
        fs: _FleetState = state.train
        b = self.batch
        n = b.n
        weights = self._weights
        part, status, est, drop_frac = self._participants(*self._key_ctx)

        bits = np.zeros(n, np.float64)
        n_tx = np.zeros(n, np.float64)
        energy = np.zeros(n, np.float64)
        erased_b = np.zeros(n, np.float64)
        steps_arr = np.zeros(n, np.int64)
        loss = np.zeros(n, np.float64)
        contributed = np.zeros(n, bool)
        outage_s = 0.0
        models: dict = {}
        new_groups: list = []

        # --- FL groups: replay each stacked upload's draw (the training
        # plane also trains and uploads on the same keys); group order
        # and the 101 + gi folds are the loop's
        for gi, (radio, members) in enumerate(self._groups):
            gk = key if gi == 0 else key.fold_in(FL_GROUP_FOLD + gi)
            sel = np.flatnonzero(part[members])
            if sel.size == 0:
                if self.train_on:
                    new_groups.append(fs.groups[gi])
                continue
            mem = members[sel]
            n_a = int(mem.size)
            if self.train_on:
                whole = n_a == members.size
                idx = torch.as_tensor(sel)
                gstate = fs.groups[gi] if whole else \
                    select_users(fs.groups[gi], idx)
                gb = {k: torch.from_numpy(np.stack(
                    [batch[i][k] for i in mem.tolist()])).to(self.device)
                    for k in ("tokens", "labels")}
                states, gmetrics = fl_local_phase(gstate, gb, gk, lr)
                dlv = fl_upload(radio, gk, states.trainable["model"])
                losses = gmetrics["loss"].cpu().numpy()       # [n_a, J]
                loss[mem] = [float(row.mean()) for row in losses]
                new_groups.append(states if whole else
                                  merge_users(fs.groups[gi], idx, states))
            ntx, er = self._fl_draw(radio, gk, n_a)
            # `Radio._deliver`'s reductions, as arrays, in its order
            ntx64 = ntx.astype(np.float64)
            width = float(radio.wire_width())
            ub = width * (self._leaf_sizes * ntx64).sum(axis=1)
            bits[mem] = ub
            n_tx[mem] = ntx64.sum(axis=1)
            energy[mem] = ub * radio.tx_power_w / radio.rate_bps()
            outage_s += W.backoff_s(ntx64, radio.arq_backoff_s)
            if radio.arq_max_tx > 0:
                ue = er.any(axis=1)
                erased_b[mem] = width * (self._leaf_sizes * ntx64
                                         * er).sum(axis=1)
            else:
                ue = np.zeros(n_a, bool)
            status[mem[ue]] = _ERASED       # trained, upload lost
            contributed[mem[~ue]] = True
            steps_arr[mem] = self._steps_round[mem]
            if self.train_on:
                for u, i in enumerate(mem.tolist()):
                    if not ue[u]:
                        models[i] = tree_map(lambda p, u=u: p[u],
                                             dlv.payload)

        # --- SL clients: replay each active client's drawn legs on the
        # loop's keys, in population order
        t_sl = time.perf_counter()
        sl_steps = np.asarray(fs.sl_steps, np.int64)
        new_sl_steps = sl_steps.copy()
        for si, i in enumerate(self._sl_idx.tolist()):
            if not part[i]:
                continue
            sk = self._sl_base if si == 0 else \
                self._sl_base.fold_in(SL_CLIENT_FOLD + si)
            n_steps = int(self._steps_round[i])
            radio = b.radios[b.radio_id[i]]
            tx, n_er, bo = sl_cycle_drawn_diag(sk, int(sl_steps[si]),
                                               n_steps, radio)
            leg = self._sl_step_bits[i] / 2.0
            bits[i] = tx * leg
            n_tx[i] = tx
            energy[i] = bits[i] * self._tx_power[i] / self._rate[i]
            erased_b[i] = (n_er * self._arq_max[i]) * leg
            outage_s += bo * self._arq_backoff[i]
            contributed[i] = True
            steps_arr[i] = n_steps
            new_sl_steps[si] += n_steps
        sl_replay_s = time.perf_counter() - t_sl

        # --- CL members: radio-silent server-side epochs
        cl_act = self._cl_idx[part[self._cl_idx]]
        contributed[cl_act] = True
        steps_arr[cl_act] = self._steps_round[cl_act]

        # --- non-participants: zero bills for sampled-out and stragglers;
        # FaultPlan casualties bill attempted-but-erased payload
        np_mask = ~part
        pe = np_mask & (status == _ERASED)
        bits[pe] = self._bits_est[pe]
        erased_b[pe] = bits[pe]
        dr = np_mask & (status == _DROPPED)
        bits[dr] = drop_frac[dr] * self._bits_est[dr]
        energy[dr] = bits[dr] * self._tx_power[dr] / self._rate[dr]
        erased_b[dr] = bits[dr]

        # --- quorum and weights (the loop's float64 renormalization)
        trained_idx = np.flatnonzero(contributed)
        need = max(1, math.ceil(self.quorum * n))
        quorum_met = trained_idx.size >= need
        renorm = 1.0 if trained_idx.size == n else (
            float(weights[trained_idx].sum()) if trained_idx.size
            else 1.0)
        w_arr = np.zeros(n, np.float64)
        if quorum_met:
            w_arr[trained_idx] = weights[trained_idx] / renorm

        # --- training plane: the loop's weighted FedAvg and re-anchor
        glob = fs.glob
        if self.train_on:
            agg = (aggregate_weighted(
                [models[i] for i in trained_idx.tolist()],
                weights[trained_idx])
                if quorum_met and trained_idx.size else fs.glob["model"])
            new_groups = [
                TrainState(dict(s.trainable, model=FED.replicate_for_users(
                    agg, len(mem))), s.opt_state, s.step)
                for (_, mem), s in zip(self._groups, new_groups)]
            glob = {"model": agg}

        client_steps = np.asarray(fs.client_steps, np.int64) + steps_arr
        self._final_client_steps = client_steps
        total_steps = int(steps_arr.sum())
        new = SchemeState(_FleetState(glob, new_groups, client_steps,
                                      new_sl_steps),
                          state.data, state.steps + total_steps,
                          state.epoch + self.epochs_per_cycle)

        counts = np.bincount(status, minlength=len(STATUS_NAMES))
        metrics = {"n_active": int(trained_idx.size),
                   "n_sampled_out": int(counts[_SAMPLED_OUT]),
                   "n_stragglers": int(counts[_STRAGGLER])}
        if self._faults_on:
            metrics.update(n_erased=int(counts[_ERASED]),
                           n_dropped_midround=int(counts[_DROPPED]),
                           quorum_met=bool(quorum_met))
        fleet = {"status_counts": {STATUS_NAMES[c]: int(counts[c])
                                   for c in range(len(STATUS_NAMES))
                                   if counts[c]},
                 "bits": _summary(bits, HIST_BINS),
                 "energy_j": _summary(energy, HIST_BINS),
                 "est_round_s": _summary(est, HIST_BINS)}
        if self.spill_top_k > 0:
            k = min(self.spill_top_k, n)
            top = np.argsort(bits, kind="stable")[::-1][:k]
            fleet["spill"] = {
                "client": [int(i) for i in top],
                "bits": [float(bits[i]) for i in top],
                "status": [STATUS_NAMES[status[i]] for i in top]}
        metrics["fleet"] = fleet

        self.last_round_detail = {
            "part": part, "status": status,
            "status_names": [STATUS_NAMES[c] for c in status],
            "bits": bits, "n_tx": n_tx, "energy_j": energy,
            "erased_bits": erased_b, "steps": steps_arr, "loss": loss,
            "weight": w_arr, "est_round_s": est,
            "drop_frac": drop_frac}
        report = RoundReport(
            loss=_seq_sum(loss * w_arr),
            steps=total_steps,
            bits=_seq_sum(bits),
            n_tx=_seq_sum(n_tx),
            energy_j=_seq_sum(energy),
            metrics=metrics,
            clients=(),
            erased_bits=_seq_sum(erased_b),
            outage_s=float(outage_s))
        self.last_round_seconds = {"round": time.perf_counter() - t_round,
                                   "sl_replay": sl_replay_s}
        return new, report

    # ------------------------------------------------------------- eval
    def evaluate(self, state, xte, yte) -> float:
        return evaluate(state.train.glob["model"], xte, yte)[0]

    def flops(self, steps_total: int):
        """Per-paradigm accounting off the cumulative step arrays (CL
        epochs run server-side; SL splits user / server at the cut)."""
        b = self.batch
        steps = self._final_client_steps.astype(np.float64)
        user = float(step_flops("cl")) * float(steps[b.paradigm == 0]
                                               .sum())
        server = float(step_flops("cl")) * float(steps[b.paradigm == 2]
                                                 .sum())
        for i in self._sl_idx.tolist():
            cf = b.wcfgs[b.wcfg_id[i]].compress_factor
            u = user_side_flops_sl(cf)
            user += u * steps[i]
            server += (step_flops("sl", cf) - u) * steps[i]
        return user, server
