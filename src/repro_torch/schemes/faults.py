"""`FaultPlan` — a deterministic, seeded per-cycle fault schedule; the
port of `repro/schemes/faults.py`.

The wire's Gilbert-Elliott / bounded-ARQ draws (core/wire.py) model
*organic* link faults. A `FaultPlan` is the *orchestrated* layer: a
reproducible schedule of whole-client outages and mid-round dropouts on
its OWN stream, so a chaos test can say "client 3 is unreachable in
cycle 5" and get the same fleet trajectory every run.

Draws: cycle c's events come from `key(seed + 11).fold_in(c)`, through
the `Draws` seam under three names ("fault_outage", "fault_dropout",
"fault_frac": the three children of the JAX package's 3-way split), so
a test can hand in the JAX package's uniforms. A plan with both
probabilities 0 draws nothing; a replayed log (`from_log`) touches no
random stream at all. The comparisons run in numpy on the float32
uniforms, as in the JAX package.

Semantics (enforced by schemes/population.py and schemes/fleet.py):
  outage          — the client is unreachable for the whole cycle: no
                    compute, status "erased", its whole expected round
                    payload billed as attempted-but-erased bits;
  mid-round drop  — the client dies a fraction `frac` of the way through
                    its upload: `frac` of its expected round bits billed
                    (all erased), status "dropped_midround", zero
                    aggregation weight.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from repro_torch.core.draws import Key

PLAN_STREAM = 11   # key(seed + 11): disjoint from every run stream


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded per-cycle outage / dropout schedule (frozen, hashable).

    p_outage:  per-(cycle, client) probability of a whole-cycle outage.
    p_dropout: per-(cycle, client) probability of a mid-round dropout
               (only clients that escaped the outage); the dropped
               fraction of the upload is itself uniform.
    log:       a recorded trace (`from_log`), a sorted tuple of
               (cycle, client, event, frac). When non-empty the plan
               REPLAYS it and ignores the probabilities.
    key:       seed -> root `Key` (the draw seam), as the schemes take it.
    """
    seed: int = 0
    p_outage: float = 0.0
    p_dropout: float = 0.0
    log: tuple = ()
    key: Any = dataclasses.field(default=Key, compare=False, repr=False)

    @property
    def active(self) -> bool:
        return bool(self.log) or self.p_outage > 0.0 or self.p_dropout > 0.0

    @classmethod
    def from_log(cls, source, seed: int = 0) -> "FaultPlan":
        """A replay plan from a RECORDED trace: a JSON list of events
        `{"cycle": int, "client": int, "event": "outage" | "dropout",
        "frac": float}` (frac, dropouts only, in (0, 1)). `source` is a
        path to such a file, the JSON text, or an iterable of dicts."""
        if isinstance(source, (str, os.PathLike)):
            s = os.fspath(source)
            if os.path.exists(s):
                with open(s) as f:
                    events = json.load(f)
            else:
                events = json.loads(s)
        else:
            events = list(source)
        log = []
        for e in events:
            kind = e["event"]
            if kind not in ("outage", "dropout"):
                raise ValueError(f"unknown fault event {kind!r}")
            frac = float(e.get("frac", 0.0))
            if kind == "dropout" and not 0.0 < frac < 1.0:
                raise ValueError(
                    f"dropout frac must be in (0, 1), got {frac}")
            log.append((int(e["cycle"]), int(e["client"]), kind, frac))
        return cls(seed=seed, log=tuple(sorted(log)))

    def _replay(self, cycle: int, n: int):
        out = np.zeros(n, bool)
        frac = np.full(n, np.nan)
        for c, client, kind, f in self.log:
            if c != cycle or not 0 <= client < n:
                continue
            if kind == "outage":
                out[client] = True
            else:
                frac[client] = np.clip(f, 1e-3, 1.0 - 1e-3)
        frac = np.where(out, np.nan, frac)   # outage wins, as when drawn
        return out, frac

    def _uniforms(self, cycle: int, n: int, dropout: bool):
        d = self.key(self.seed + PLAN_STREAM).fold_in(cycle).draws()
        u = d.uniform("fault_outage", (n,), 0.0, 1.0).numpy()
        if not dropout:
            return u, None, None
        return (u, d.uniform("fault_dropout", (n,), 0.0, 1.0).numpy(),
                d.uniform("fault_frac", (n,), 0.0, 1.0).numpy())

    def events(self, cycle: int, n: int):
        """-> (outage [n] bool, drop_frac [n]) for one cycle. drop_frac
        is NaN where a client does not drop mid-round. Plans with both
        probabilities 0 return without drawing."""
        out = np.zeros(n, bool)
        frac = np.full(n, np.nan)
        if n == 0:
            return out, frac
        if self.log:
            return self._replay(cycle, n)
        if not self.active:
            return out, frac
        u, ud, uf = self._uniforms(cycle, n, self.p_dropout > 0.0)
        out = u < self.p_outage
        if self.p_dropout > 0.0:
            drop = (~out) & (ud < self.p_dropout)
            frac = np.where(drop, np.clip(uf, 1e-3, 1.0 - 1e-3), np.nan)
        return out, frac

    def events_arrays(self, cycle: int, p_outage, p_dropout):
        """`events` with per-CLIENT probabilities ([n] arrays) on the same
        stream (the fleet engine's path). The dropout uniforms are drawn
        iff any client has p_dropout > 0."""
        p_outage = np.asarray(p_outage, np.float64)
        p_dropout = np.asarray(p_dropout, np.float64)
        n = int(p_outage.shape[0])
        out = np.zeros(n, bool)
        frac = np.full(n, np.nan)
        if n == 0:
            return out, frac
        if self.log:
            return self._replay(cycle, n)
        if not (np.any(p_outage > 0.0) or np.any(p_dropout > 0.0)):
            return out, frac
        dropout = bool(np.any(p_dropout > 0.0))
        u, ud, uf = self._uniforms(cycle, n, dropout)
        out = u < p_outage
        if dropout:
            drop = (~out) & (ud < p_dropout)
            frac = np.where(drop, np.clip(uf, 1e-3, 1.0 - 1e-3), np.nan)
        return out, frac
