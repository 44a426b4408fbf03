"""`RequestTrace` — the port of `repro/serve/trace.py`: the same
JSON format (`repro.serve/RequestTrace/v1`) loads in both packages.

A trace is (seed, requests); a request is (rid, arrival_cycle,
prompt_len, max_new_tokens, snr_db). Everything else the engine does —
prompt token content, channel noise, ARQ draws, sampling — is a pure
function of the trace seed and the request id (see engine.py's draw
seam), so an engine run is reproducible from the JSON alone:
same (seed, trace) => same generated tokens AND same billing.

Replay convention (docs/ACCOUNTING.md §Serving):

* `arrival_cycle` is measured in ENGINE DECODE CYCLES (one batched
  decode_step over the slot axis = one cycle), not seconds — wall time
  per cycle is a property of the hardware, while the trace must replay
  bit-for-bit everywhere.
* `snr_db` is the per-user link budget: the engine builds each user's
  `Radio` as `dataclasses.replace(base_radio, snr_db=...)`, the same
  override convention `ClientSpec` uses for training fleets.
* Requests are processed in (arrival_cycle, rid) order; rid ties are
  the admission order, so a trace with simultaneous arrivals is still
  deterministic.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One user's inference request (lengths only — prompt token ids
    derive from the trace seed + rid inside the engine)."""
    rid: int
    arrival_cycle: int
    prompt_len: int
    max_new_tokens: int
    snr_db: float = 20.0


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    seed: int
    requests: Tuple[Request, ...]

    def sorted(self) -> Tuple[Request, ...]:
        return tuple(sorted(self.requests,
                            key=lambda r: (r.arrival_cycle, r.rid)))

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def max_seq_len(self) -> int:
        """Smallest per-slot cache length that fits every request: the
        last fed token of a request sits at index P + N - 2."""
        return max(r.prompt_len + r.max_new_tokens for r in self.requests)

    # ------------------------------------------------------------ replay
    def to_json(self) -> str:
        return json.dumps({
            "format": "repro.serve/RequestTrace/v1",
            "seed": self.seed,
            "requests": [dataclasses.asdict(r) for r in self.requests],
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "RequestTrace":
        obj = json.loads(text)
        return cls(int(obj["seed"]),
                   tuple(Request(**r) for r in obj["requests"]))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "RequestTrace":
        with open(path) as f:
            return cls.from_json(f.read())


def make_trace(seed: int, n_requests: int, prompt_lens=(4, 24),
               new_tokens=(2, 16), mean_gap: float = 1.0,
               snr_dbs=(5.0, 10.0, 20.0)) -> RequestTrace:
    """Synthetic open-loop arrival trace: geometric inter-arrival gaps
    of mean `mean_gap` cycles, prompt/output lengths uniform over the
    inclusive ranges, per-user SNR cycled through `snr_dbs`. Pure
    function of its arguments (np.random.default_rng(seed))."""
    rng = np.random.default_rng(seed)
    reqs, cycle = [], 0
    for rid in range(n_requests):
        p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        n = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        snr = float(snr_dbs[rid % len(snr_dbs)])
        reqs.append(Request(rid, cycle, p, n, snr))
        if mean_gap > 0:
            cycle += int(rng.geometric(min(1.0, 1.0 / (mean_gap + 1.0))) - 1)
    return RequestTrace(seed, tuple(reqs))


def uniform_trace(seed: int, n_requests: int, prompt_len: int,
                  max_new_tokens: int, snr_db: float = 20.0
                  ) -> RequestTrace:
    """All-alike, all-at-cycle-0 trace — the legacy static-batch demo
    (`launch/serve.py`) expressed as a RequestTrace."""
    return RequestTrace(seed, tuple(
        Request(rid, 0, prompt_len, max_new_tokens, snr_db)
        for rid in range(n_requests)))
