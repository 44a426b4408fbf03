"""`Experiment` — the ONE driver loop for every scheme, plus
`build_scheme` to map a WirelessConfig onto its paradigm — the port of
`repro/schemes/run.py` for the paper's tiny CL/FL/SL schemes. The loop
keeps the JAX package's streams: data rng `seed+1`, per-step keys
`Key(seed+2).fold_in(step)` for CL/SL, per-cycle keys
`Key(seed+3).fold_in(cycle)` for FL, CL upload key `Key(seed+7)`.

    scheme = build_scheme(WirelessConfig(mode="fl", quant_bits=8))
    res = Experiment(scheme, cycles=7).run()     # -> RunResult

Populations and fleets (`clients=`), the scaled schemes (a non-tiny
`cfg`) and checkpoint/resume are still to port (ROADMAP.md) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.schemes.base import (N_TEST, N_TRAIN, RoundReport,
                                      RunResult, SchemeState, corpus, lr_at)
from repro_torch.schemes.centralized import CentralizedScheme
from repro_torch.schemes.federated import FederatedScheme
from repro_torch.schemes.radio import Delivery
from repro_torch.schemes.split import SplitScheme


def build_scheme(wcfg=None, capture: bool = False, clients=None,
                 cfg=None, **kwargs):
    """(WirelessConfig, arch) -> Scheme. None wcfg means the no-radio CL
    baseline. `capture=True` records each scheme's privacy observations
    into `RunResult.captures`. Extra kwargs go to the scheme constructor
    (`device`, `key`; FL's `quorum`, `shards`, `dp_sigma`, `dp_clip`,
    `prox_mu` and `sample_with_replacement`; SL's `protocol`,
    `capture_every` and `perfect_eval`)."""
    if clients is not None:
        raise NotImplementedError(
            "build_scheme: populations and fleets (clients=) are not "
            "ported yet (see ROADMAP.md, P14)")
    if cfg is not None and cfg.family != "tiny":
        raise NotImplementedError(
            f"build_scheme: the scaled schemes (family {cfg.family!r}) are "
            f"not ported yet (see ROADMAP.md, P15)")
    mode = wcfg.mode if wcfg is not None else "cl"
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
    (`seed + 1`), the paper's lr schedule off the scheme's epoch counter,
    one `round` per cycle, eval after each.
    Per-cycle accounting lands in `reports`; any init-time crossing (the
    CL corpus upload) in `init_delivery`. `on_init(state)` may return a
    replacement SchemeState (the tests hand in the JAX package's initial
    weights this way)."""
    scheme: Any
    cycles: int
    seed: int = 0
    n_train: int = N_TRAIN
    n_test: int = N_TEST
    on_init: Optional[Callable[[SchemeState], Optional[SchemeState]]] = None
    on_cycle: Optional[Callable[[int, float, RoundReport], None]] = None
    checkpoint_every: int = 0
    resume_from: Optional[str] = None
    reports: list = dataclasses.field(default_factory=list)
    init_delivery: Optional[Delivery] = None
    final_state: Any = None

    def run(self) -> RunResult:
        if self.checkpoint_every > 0 or self.resume_from is not None:
            raise NotImplementedError(
                "Experiment: checkpointing and resume are not ported yet "
                "(see ROADMAP.md, P14)")
        (xtr, ytr), (xte, yte) = corpus(self.n_train, self.n_test,
                                        self.seed)
        state, self.init_delivery = self.scheme.init(self.seed, xtr, ytr)
        if self.on_init is not None:
            state = self.on_init(state) or state
        total_bits = self.init_delivery.bits if self.init_delivery else 0.0
        rng = np.random.default_rng(self.seed + 1)
        accs, losses = [], []
        for cyc in range(self.cycles):
            lr = lr_at(state.epoch)
            batch = self.scheme.cycle_batches(state, rng, cyc)
            key = self.scheme.round_key(self.seed, cyc)
            state, rep = self.scheme.round(state, batch, key, lr)
            self.final_state = state
            self.reports.append(rep)
            total_bits += rep.bits
            acc = self.scheme.evaluate(state, xte, yte)
            accs.append(acc)
            losses.append(rep.loss)
            if self.on_cycle is not None:
                self.on_cycle(cyc, acc, rep)
        self.final_state = state
        user_f, server_f = self.scheme.flops(state.steps)
        return RunResult(accs, losses,
                         total_bits / self.scheme.bits_normalizer,
                         user_flops=user_f, server_flops=server_f,
                         captures=self.scheme.captures)
