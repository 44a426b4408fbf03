"""`Experiment` — the ONE driver loop for every scheme, plus
`build_scheme` to map a WirelessConfig (or a list of clients) onto its
scheme — the port of `repro/schemes/run.py` for the paper's tiny model
and the scaled schemes. The loop keeps the JAX package's streams: data
rng `seed+1`, per-step keys `Key(seed+2).fold_in(step)` for CL/SL,
per-cycle keys `Key(seed+3).fold_in(cycle)` for FL, CL upload key
`Key(seed+7)` (the scaled CL/SL steps fold off `Key(seed)`).

    scheme = build_scheme(WirelessConfig(mode="fl", quant_bits=8))
    res = Experiment(scheme, cycles=7).run()     # -> RunResult

    # a heterogeneous fleet, and its struct-of-arrays engine
    scheme = build_scheme(base, clients=[ClientSpec.fl(base), ...])
    scheme = build_scheme(base, clients=specs, engine="fleet")

    # crash-consistent: snapshot every cycle, resume from the latest
    Experiment(scheme, cycles=7, checkpoint_dir="ck", checkpoint_every=1)
    Experiment(scheme, cycles=7, resume_from="ck").run()

    # the dense family at scale (schemes/scaled.py): synthetic LM corpus
    # and a constant 3e-4 lr unless data / lr_schedule are given
    scheme = build_scheme(WirelessConfig(mode="fl"),
                          cfg=get_arch("qwen1.5-0.5b"))
    Experiment(scheme, cycles=2, n_train=512, n_test=128).run()
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.schemes.base import (N_TEST, N_TRAIN, ClientReport,
                                      RoundReport, RunResult, SchemeState,
                                      corpus, lr_at)
from repro_torch.schemes.centralized import CentralizedScheme
from repro_torch.schemes.federated import FederatedScheme
from repro_torch.schemes.population import PopulationScheme
from repro_torch.schemes.radio import Delivery
from repro_torch.schemes.split import SplitScheme


def build_scheme(wcfg=None, capture: bool = False, clients=None,
                 cfg=None, shape=None, **kwargs):
    """(WirelessConfig, arch) -> Scheme. None wcfg means the no-radio CL
    baseline. `capture=True` records each scheme's privacy observations
    into `RunResult.captures`. A `clients` list of ClientSpecs selects a
    `PopulationScheme` (wcfg is the shared base config), or with
    `engine="fleet"` a `FleetScheme` over the same specs; a
    `ClientBatch` always selects a `FleetScheme`. Extra kwargs go to the
    scheme constructor (`device`, `key`; FL's `quorum`, `shards`,
    `dp_sigma`, `dp_clip`, `prox_mu` and `sample_with_replacement`;
    SL's `protocol`, `capture_every` and `perfect_eval`; the fleets'
    `policy`, `deadline_s`, `deadline_jitter_sigma`, `quorum`,
    `fault_plan`, and the fleet engine's `train`, `train_cap`,
    `spill_top_k`). A non-tiny `cfg` selects the scaled schemes
    (schemes/scaled.py) at `shape` (default batch 8, seq 128), with
    their `steps_per_cycle` and `optimizer`."""
    if clients is not None:
        from repro_torch.schemes.fleet import ClientBatch, FleetScheme
        engine = kwargs.pop("engine", "auto")
        if isinstance(clients, ClientBatch):
            return FleetScheme(wcfg, clients, capture=capture, **kwargs)
        if engine == "fleet":
            return FleetScheme(wcfg, ClientBatch.from_specs(clients),
                               capture=capture, **kwargs)
        if engine not in ("auto", "loop"):
            raise ValueError(f"unknown fleet engine {engine!r} "
                             "(auto|loop|fleet)")
        return PopulationScheme(wcfg, clients, capture=capture, **kwargs)
    mode = wcfg.mode if wcfg is not None else "cl"
    if cfg is not None and cfg.family != "tiny":
        from repro_torch.schemes.scaled import (ScaledCentralizedScheme,
                                                ScaledFederatedScheme,
                                                ScaledSplitScheme)
        cls = {"cl": ScaledCentralizedScheme,
               "fl": ScaledFederatedScheme,
               "sl": ScaledSplitScheme}.get(mode)
        if cls is None:
            raise ValueError(f"unknown scheme mode {mode!r}")
        return cls(cfg, shape=shape, wcfg=wcfg, capture=capture, **kwargs)
    if mode == "cl":
        return CentralizedScheme(wcfg, capture=capture, **kwargs)
    if mode == "fl":
        return FederatedScheme(wcfg, capture=capture, **kwargs)
    if mode == "sl":
        return SplitScheme(wcfg, capture=capture, **kwargs)
    raise ValueError(f"unknown scheme mode {mode!r}")


@dataclasses.dataclass
class Experiment:
    """Drive a scheme for `cycles` communication cycles: one data rng
    (`seed + 1`), the lr from `lr_schedule` (epoch -> lr; default the
    paper's schedule off the scheme's epoch counter) times `lr_scale`,
    one `round` per cycle, eval after each. Per-cycle accounting lands
    in `reports` (for fleets with the per-client breakdown); any
    init-time crossing (CL corpus uploads) in `init_delivery`. Data: an
    explicit `data` ((xtr, ytr), (xte, yte)) wins, else the sentiment
    corpus at `n_train` / `n_test`. `on_init(state)` may return a
    replacement SchemeState (the tests hand in the JAX package's
    initial weights this way). A scheme with `default_data` /
    `default_lr_schedule` (the scaled schemes) supplies the corpus and
    the schedule when none is given.

    Crash-consistent resume: `checkpoint_every` > 0 snapshots the run
    every k cycles into `checkpoint_dir` (train state, data-rng state,
    cycle index, reports and bills so far, in one atomic file;
    checkpoint/ckpt.py); `resume_from` (a snapshot or a checkpoint
    directory, the latest wins) restores it and continues, giving the
    uninterrupted run's trajectory and bills bit for bit. `init` re-runs
    on resume (it is deterministic from the seed; an init-time CL upload
    is in the snapshot's total and is not billed twice); privacy
    captures are not resumed."""
    scheme: Any
    cycles: int
    seed: int = 0
    n_train: int = N_TRAIN
    n_test: int = N_TEST
    lr_scale: float = 1.0
    lr_schedule: Optional[Callable[[int], float]] = None
    data: Optional[tuple] = None
    on_init: Optional[Callable[[SchemeState], Optional[SchemeState]]] = None
    on_cycle: Optional[Callable[[int, float, RoundReport], None]] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume_from: Optional[str] = None
    reports: list = dataclasses.field(default_factory=list)
    init_delivery: Optional[Delivery] = None
    final_state: Any = None

    def _data(self):
        if self.data is not None:
            return self.data
        if hasattr(self.scheme, "default_data"):
            return self.scheme.default_data(self.n_train, self.n_test,
                                            self.seed)
        return corpus(self.n_train, self.n_test, self.seed)

    def _check_checkpointable(self):
        if getattr(self.scheme, "protocol", None) == "two_party":
            raise ValueError(
                "checkpointing/resume needs the scheme's whole train "
                "state as a tree of tensors; the two-party SL protocol "
                "holds a live SLSession — use the (bit-identical) fused "
                "SL path instead")

    def _snapshot(self, next_cycle, state, rng, accs, losses, total_bits):
        from repro_torch.checkpoint import ckpt as CKPT
        meta = {"cycle": int(next_cycle),
                "steps": int(state.steps), "epoch": int(state.epoch),
                "rng_state": rng.bit_generator.state,
                "accs": accs, "losses": losses,
                "total_bits": float(total_bits),
                "reports": [dataclasses.asdict(r) for r in self.reports]}
        return CKPT.save_experiment(self.checkpoint_dir, next_cycle,
                                    state.train, meta)

    def _restore(self, state, rng):
        from repro_torch.checkpoint import ckpt as CKPT
        train, meta = CKPT.load_experiment(self.resume_from, state.train)
        rng.bit_generator.state = meta["rng_state"]
        self.reports = [
            RoundReport(**dict(
                r, clients=tuple(ClientReport(**c)
                                 for c in (r.get("clients") or ()))))
            for r in meta["reports"]]
        state = SchemeState(train, state.data,
                            int(meta["steps"]), int(meta["epoch"]))
        return (state, int(meta["cycle"]), list(meta["accs"]),
                list(meta["losses"]), float(meta["total_bits"]))

    def run(self) -> RunResult:
        if self.checkpoint_every > 0 and not self.checkpoint_dir:
            raise ValueError("checkpoint_every > 0 needs checkpoint_dir")
        if self.checkpoint_every > 0 or self.resume_from is not None:
            self._check_checkpointable()
        (xtr, ytr), (xte, yte) = self._data()
        state, self.init_delivery = self.scheme.init(self.seed, xtr, ytr)
        if self.on_init is not None:
            state = self.on_init(state) or state
        total_bits = self.init_delivery.bits if self.init_delivery else 0.0
        rng = np.random.default_rng(self.seed + 1)
        accs, losses = [], []
        start_cycle = 0
        if self.resume_from is not None:
            # init re-ran above; the snapshot's total already holds any
            # init-time upload, so it is not billed twice
            state, start_cycle, accs, losses, total_bits = \
                self._restore(state, rng)
        sched = (self.lr_schedule
                 or getattr(self.scheme, "default_lr_schedule", None)
                 or lr_at)
        for cyc in range(start_cycle, self.cycles):
            lr = sched(state.epoch) * self.lr_scale
            batch = self.scheme.cycle_batches(state, rng, cyc)
            key = self.scheme.round_key(self.seed, cyc)
            state, rep = self.scheme.round(state, batch, key, lr)
            self.final_state = state     # live: on_cycle may read it
            self.reports.append(rep)
            total_bits += rep.bits
            acc = self.scheme.evaluate(state, xte, yte)
            accs.append(acc)
            losses.append(rep.loss)
            if self.on_cycle is not None:
                self.on_cycle(cyc, acc, rep)
            if (self.checkpoint_every > 0
                    and (cyc + 1) % self.checkpoint_every == 0):
                # post-cycle: the rng state is what cycle cyc + 1 draws
                self._snapshot(cyc + 1, state, rng, accs, losses,
                               total_bits)
        self.final_state = state
        user_f, server_f = self.scheme.flops(state.steps)
        return RunResult(accs, losses,
                         total_bits / self.scheme.bits_normalizer,
                         user_flops=user_f, server_flops=server_f,
                         captures=self.scheme.captures)
