"""Continuous-batching semantic serving engine over per-user Radios — the
port of `repro/serve/engine.py`.

Many users stream prompts up through their OWN `Radio` and receive the
generated tokens back down it; the server runs one batched decode step
over a fixed-capacity slot axis every cycle. `mode="continuous"` re-admits
a freed slot on the next cycle; `mode="static"` admits only when every
slot is free. `prefill="chunked"` admits prompts in bucketed chunks of up
to `chunk_size` tokens per cycle (one prefill launch per layer and chunk
with `prefill_impl="fused"`, the default on CUDA), `prefill="token"` one
token per cycle through the decode step. `kv="paged"` keeps the KV in one
shared page pool (serve/paging.PagePool), `kv="dense"` in a per-slot
[B, Hkv, S, hd] cache. On CUDA every decode step runs the decode kernel
(paged or dense) once per layer and every chunk the prefill kernel.
The VLM serves like the dense family, on tokens only (the JAX engine
passes no patch embeddings). So does the MoE family; its expert capacity
is per call, so a fused chunk's drops depend on every row the chunk holds
(idle rows and padded tails route too, as in the JAX engine), while a
decode step of at most 8 slots cannot drop (capacity >= 8).
The paper's tiny classifier serves too: its O(1) recurrent cache has
nothing to page (`kv="paged"` degrades to dense), its chunks are
prefilled by the exact scan of its decode step, and its "generated
token" is the sentiment class (2 output logits).

Billing is independent of all three switches: prompt tokens ride the
uplink via `Radio.send_tokens` before the first chunk runs, every radio
draw is keyed only by (request, leg, attempt) and every sampling draw by
(request, token index), so bills and tokens agree across modes.

Random draws go through a seam (`draws`, a factory called with the
trace seed; default `ServeDraws`) that supplies prompt ids, each
crossing's channel draws and the Gumbel noise of sampling, so a test can
hand the JAX engine's draws to the port. Without such injection the
port's streams differ from the JAX package's (torch generators are not
threefry).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.draws import seeded
from repro_torch.models import api as M
from repro_torch.models import transformer as _tfm
from repro_torch.nn import resolve_device, tree_map
from repro_torch.runtime.serve_step import (logit_width, make_decode_step,
                                            make_paged_decode_step,
                                            make_paged_prefill_step,
                                            make_prefill_step)
from repro_torch.schemes.radio import Radio
from repro_torch.serve.paging import (PagePool, bucket_for, pages_needed,
                                      prefill_buckets)
from repro_torch.serve.trace import RequestTrace

#: families whose decode path accepts a per-slot [B] index vector (the
#: JAX package's; the others serve through launch/serve.py's static loop)
SLOT_FAMILIES = ("dense", "moe", "vlm", "tiny")
#: families whose KV cache can live in the shared page pool
PAGED_FAMILIES = ("dense", "moe", "vlm")
#: the serving RNG stream offset (docs/ACCOUNTING.md §RNG)
SERVE_STREAM = 13
#: legs of a request's crossings, as the JAX package folds them
UPLINK, DOWNLINK = 1, 2


class ServeDraws:
    """The port's own serving draws: one seeded torch stream per
    (trace seed + 13, request, purpose, ...)."""

    def __init__(self, seed: int):
        self.base = int(seed) + SERVE_STREAM

    def prompt(self, rid: int, n: int, vocab: int) -> np.ndarray:
        """Prompt ids of request `rid`: [n] int32 in [1, vocab)."""
        g = seeded(self.base, rid, 3).generator
        return torch.randint(1, vocab, (n,), generator=g,
                             dtype=torch.int64).numpy().astype(np.int32)

    def link(self, rid: int, leg: int, attempt: int):
        """Channel `Draws` of one crossing (leg 1 up, 2 down)."""
        return seeded(self.base, rid, leg, attempt)

    def gumbel(self, rid: int, t: int, vocab: int) -> torch.Tensor:
        """Gumbel noise [vocab] f32 for sampling generated token `t`."""
        g = seeded(self.base, rid, 9, t).generator
        u = torch.rand(vocab, generator=g).clamp_min(1e-20)
        return -torch.log(-torch.log(u))


@dataclasses.dataclass
class RequestResult:
    """One request's outcome + its exact radio bill."""
    rid: int
    status: str = "queued"       # ok | downlink_erased | uplink_erased
    tokens: Tuple[int, ...] = ()
    prompt_len: int = 0
    snr_db: float = 0.0
    admit_cycle: int = -1
    complete_cycle: int = -1
    latency_cycles: int = -1     # completion - arrival + 1 (queue incl.)
    first_token_cycle: int = -1
    ttft_cycles: int = -1        # first token - arrival + 1 (queue incl.)
    ttft_s: float = -1.0         # admission -> first token, wall seconds
    uplink_bits: float = 0.0
    downlink_bits: float = 0.0
    bits: float = 0.0
    erased_bits: float = 0.0
    energy_j: float = 0.0
    n_tx: float = 0.0
    outage_s: float = 0.0


@dataclasses.dataclass
class ServeReport:
    """Whole-run outcome: per-request results + engine aggregates."""
    mode: str
    n_slots: int
    results: Tuple[RequestResult, ...]
    cycles: int
    wall_s: float
    prefill: str = "token"
    kv: str = "dense"
    n_pages: int = 0
    peak_pages: int = 0

    @property
    def generated_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.results)

    @property
    def bits(self) -> float:
        return sum(r.bits for r in self.results)

    @property
    def erased_bits(self) -> float:
        return sum(r.erased_bits for r in self.results)

    @property
    def delivered_bits(self) -> float:
        return self.bits - self.erased_bits

    @property
    def energy_j(self) -> float:
        return sum(r.energy_j for r in self.results)

    def latencies(self):
        return sorted(r.latency_cycles for r in self.results
                      if r.latency_cycles >= 0)

    def latency_quantile(self, q: float) -> float:
        lat = self.latencies()
        if not lat:
            return float("nan")
        return float(lat[min(len(lat) - 1, int(q * len(lat)))])

    def ttfts_cycles(self):
        return sorted(r.ttft_cycles for r in self.results
                      if r.ttft_cycles >= 0)

    def ttfts_s(self):
        return sorted(r.ttft_s for r in self.results if r.ttft_s >= 0)

    def ttft_quantile(self, q: float, unit: str = "cycles") -> float:
        vals = self.ttfts_cycles() if unit == "cycles" else self.ttfts_s()
        if not vals:
            return float("nan")
        return float(vals[min(len(vals) - 1, int(q * len(vals)))])

    def tokens_per_s(self) -> float:
        return self.generated_tokens / max(self.wall_s, 1e-9)

    def to_dict(self) -> dict:
        return {
            "mode": self.mode, "n_slots": self.n_slots,
            "prefill": self.prefill, "kv": self.kv,
            "n_pages": self.n_pages, "peak_pages": self.peak_pages,
            "cycles": self.cycles, "wall_s": self.wall_s,
            "generated_tokens": self.generated_tokens,
            "tokens_per_s": self.tokens_per_s(),
            "bits": self.bits, "erased_bits": self.erased_bits,
            "delivered_bits": self.delivered_bits,
            "energy_j": self.energy_j,
            "p50_latency_cycles": self.latency_quantile(0.50),
            "p99_latency_cycles": self.latency_quantile(0.99),
            "p50_ttft_cycles": self.ttft_quantile(0.50),
            "p99_ttft_cycles": self.ttft_quantile(0.99),
            "p50_ttft_s": self.ttft_quantile(0.50, "s"),
            "p99_ttft_s": self.ttft_quantile(0.99, "s"),
            "statuses": {s: sum(1 for r in self.results if r.status == s)
                         for s in sorted({r.status for r in self.results})},
        }


class ServeEngine:
    """Slot-based inference server for one model over one base Radio.

    `radio` carries the shared link knobs; each request's own `snr_db`
    overrides the budget per user. `None` = ideal noiseless links, still
    billed. `prefill`/`kv` pick the admission plane and the KV layout,
    `prefill_impl` the chunk implementation ("auto": fused on CUDA, scan
    on the CPU — the JAX package's REPRO_PREFILL_IMPL). `device` is where
    the model runs ("cuda" by default; raises without a GPU)."""

    def __init__(self, cfg, params, *, n_slots: int = 8,
                 radio: Optional[Radio] = None, temperature: float = 1.0,
                 greedy: bool = False, max_link_tries: int = 2,
                 prefill: str = "chunked", kv: str = "paged",
                 chunk_size: int = 32, page_size: int = 16,
                 page_budget: int = 0, prefill_impl: str = "auto",
                 device="cuda", draws=ServeDraws):
        if cfg.family not in SLOT_FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} has no per-slot decode path; the "
                f"engine serves {SLOT_FAMILIES}, the others run the static "
                f"loop of launch/serve.py (legacy_main)")
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if prefill not in ("chunked", "token"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        if kv not in ("paged", "dense"):
            raise ValueError(f"unknown kv layout {kv!r}")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda a: a.to(self.device), params) \
            if isinstance(params, dict) else params.to(self.device)
        self.n_slots = int(n_slots)
        self.radio = radio if radio is not None \
            else Radio(perfect=True, fading=False)
        self.temperature = float(temperature)
        self.greedy = bool(greedy)
        self.max_link_tries = max(1, int(max_link_tries))
        self.prefill = prefill
        # recurrent O(1) caches have nothing to page: degrade to dense
        self.kv = kv if cfg.family in PAGED_FAMILIES else "dense"
        self.chunk_size = int(chunk_size)
        self.page_size = int(page_size)
        self.page_budget = int(page_budget)
        self.prefill_impl = prefill_impl
        self.draws = draws
        self.out_vocab = logit_width(cfg)
        self._model = M.get_model(cfg)
        self._built = {}

    # ------------------------------------------------------------- steps
    def build(self, S: int) -> dict:
        """The step functions and sizes the serve loop uses for per-slot
        cache length `S`: "decode"(cache, tokens, idx, active, tables)
        -> logits [B,1,V]; "prefill"(cache, tokens, start, n_valid,
        tables) -> (last logits [B,V] f32, cache) in chunked mode;
        "new_cache"(); "clear"(cache, slot, pages). Caches are updated
        in place."""
        if S in self._built:
            return self._built[S]
        cfg, B, dev = self.cfg, self.n_slots, self.device
        sc = ShapeConfig("serve", S, B, "decode")
        params = self.params
        out = {"buckets": prefill_buckets(self.chunk_size)}
        if self.kv == "paged":
            n_lp = -(-S // self.page_size)
            n_pages = self.page_budget or B * n_lp
            out["n_lp"], out["n_pages"] = n_lp, int(n_pages)
            step = make_paged_decode_step(cfg, sc, self.page_size)
            out["decode"] = lambda cache, toks, idx, act, tbl: step(
                params, cache, toks, idx, tbl, act)[0]
            out["new_cache"] = lambda: _tfm.init_paged_cache(
                cfg, n_pages, self.page_size, dev)

            def clear(cache, b, pids):
                for leaf in cache.values():
                    leaf[:, torch.as_tensor(pids, device=dev)] = 0
            if self.prefill == "chunked":
                pf = make_paged_prefill_step(cfg, sc, self.page_size,
                                             self.prefill_impl, dev)
                out["prefill"] = lambda cache, toks, st, nv, tbl: pf(
                    params, cache, toks, st, nv, tbl)
        else:
            step = make_decode_step(cfg, sc)
            out["decode"] = lambda cache, toks, idx, act, tbl: step(
                params, cache, toks, idx, act)[0]
            model = self._model
            out["new_cache"] = lambda: model.init_cache(cfg, B, S, dev)
            # each leaf's batch axis, as its cache_shapes names it
            bax = {k: ax.index("batch") for k, (sh, ax, dt) in
                   model.cache_shapes(cfg, B, S).items()}

            def clear(cache, b, pids):
                for k, leaf in cache.items():
                    leaf.select(bax[k], b).zero_()
            if self.prefill == "chunked":
                pf = make_prefill_step(cfg, sc, self.prefill_impl, dev)
                out["prefill"] = lambda cache, toks, st, nv, tbl: pf(
                    params, cache, toks, st, nv)
        out["clear"] = clear
        self._built[S] = out
        return out

    def warmup_compile(self, max_seq_len: int) -> float:
        """Build what the serve loop will run for `max_seq_len` and run it
        once: on CUDA the kernel libraries are compiled (one nvcc per
        source, in parallel), then one decode step and one chunk of every
        prefill bucket run on a scratch cache. Returns the wall seconds."""
        t0 = time.perf_counter()
        S = max(8, int(max_seq_len))
        built = self.build(S)
        if self.device.type == "cuda":
            from repro_torch.kernels import build as kbuild
            kbuild.build_all()
        B, dev = self.n_slots, self.device
        cache = built["new_cache"]()
        tables = torch.zeros((B, built.get("n_lp", 1)), dtype=torch.int32,
                             device=dev)
        idx = torch.zeros(B, dtype=torch.int32, device=dev)
        act = torch.ones(B, dtype=torch.bool, device=dev)
        with torch.inference_mode():
            built["decode"](cache, torch.ones((B, 1), dtype=torch.int32,
                                              device=dev), idx, act, tables)
            for C in built["buckets"] if "prefill" in built else ():
                built["prefill"](cache, torch.ones((B, C), dtype=torch.int32,
                                                   device=dev), idx,
                                 torch.full((B,), C, dtype=torch.int32,
                                            device=dev), tables)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    # ------------------------------------------------------------- radio
    def _bill(self, res: RequestResult, d, leg: int) -> None:
        res.bits += d.bits
        res.erased_bits += d.erased_bits
        res.energy_j += d.energy_j
        res.n_tx += d.n_tx
        res.outage_s += d.outage_s
        if leg == UPLINK:
            res.uplink_bits += d.bits
        else:
            res.downlink_bits += d.bits

    def _send_row(self, radio: Radio, draws, rid: int, leg: int,
                  row: np.ndarray, vocab: int, res: RequestResult):
        """One row of token ids through `radio`, retried up to
        `max_link_tries` sends under bounded ARQ. Returns (received row
        | None if every try was erased, erased_last_try)."""
        payload, erased = None, False
        for attempt in range(self.max_link_tries):
            d = radio.send_tokens(draws.link(rid, leg, attempt),
                                  torch.tensor(row)[None, :], vocab)
            self._bill(res, d, leg)
            erased = bool(d.user_erased[0]) if d.user_erased else False
            if not erased:
                payload = np.asarray(d.payload[0])
                break
        return payload, erased

    def _sample(self, lg: torch.Tensor, draws, who: dict) -> np.ndarray:
        """Next token per row from f32 logits [B,V]: argmax when greedy,
        else argmax(lg / T + Gumbel) with the noise of (rid, t) for the
        rows in `who` (row -> (rid, t)) — jax.random.categorical's rule."""
        if not self.greedy:
            g = torch.zeros_like(lg)
            for b, (rid, t) in who.items():
                g[b] = draws.gumbel(rid, t, lg.shape[-1]).to(lg.device)
            lg = lg / max(self.temperature, 1e-6) + g
        return lg.argmax(dim=-1).cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------- serve
    def serve(self, trace: RequestTrace, mode: str = "continuous"
              ) -> ServeReport:
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown mode {mode!r}")
        with torch.inference_mode():
            return self._serve(trace, mode)

    def _serve(self, trace: RequestTrace, mode: str) -> ServeReport:
        barrier = mode == "static"
        cfg, B, dev = self.cfg, self.n_slots, self.device
        reqs = trace.sorted()
        if not reqs:
            return ServeReport(mode, B, (), 0, 0.0, prefill=self.prefill,
                               kv=self.kv)
        S = max(8, trace.max_seq_len())
        built = self.build(S)
        chunked = self.prefill == "chunked"
        paged = self.kv == "paged"
        draws = self.draws(trace.seed)

        results = {}
        slots = [None] * B
        cache = built["new_cache"]()
        if paged:
            n_lp, n_pages = built["n_lp"], built["n_pages"]
            pool = PagePool(n_pages)
            tables = np.zeros((B, n_lp), np.int32)
        else:
            pool, tables = None, np.zeros((B, 1), np.int32)
        qi, cycle = 0, 0
        t0 = time.time()

        def to_dev(a):
            return torch.from_numpy(a).to(dev)

        def admit(r) -> Optional[dict]:
            res = RequestResult(r.rid, prompt_len=r.prompt_len,
                                snr_db=r.snr_db)
            results[r.rid] = res
            prompt = draws.prompt(r.rid, r.prompt_len, cfg.vocab_size)
            radio = dataclasses.replace(self.radio, snr_db=r.snr_db)
            rx, erased = self._send_row(radio, draws, r.rid, UPLINK, prompt,
                                        cfg.vocab_size, res)
            if erased:
                res.status = "uplink_erased"     # abandoned, bill stands
                return None
            res.status = "serving"
            res.admit_cycle = cycle
            return {"r": r, "res": res, "radio": radio, "prompt": rx,
                    "pos": 0, "last": 0, "new": [],
                    "admit_wall": time.time()}

        def push_token(st, tok: int) -> None:
            st["new"].append(tok)
            st["last"] = tok
            if len(st["new"]) == 1:
                res = st["res"]
                res.first_token_cycle = cycle
                res.ttft_cycles = cycle - st["r"].arrival_cycle + 1
                res.ttft_s = time.time() - st["admit_wall"]

        def complete(st) -> None:
            r, res = st["r"], st["res"]
            gen = np.asarray(st["new"], np.int32)
            _, erased = self._send_row(st["radio"], draws, r.rid, DOWNLINK,
                                       gen, self.out_vocab, res)
            res.status = "downlink_erased" if erased else "ok"
            res.tokens = tuple(int(t) for t in gen)
            res.complete_cycle = cycle
            res.latency_cycles = cycle - r.arrival_cycle + 1
            if paged:
                pool.free(st.pop("pgs"))

        while qi < len(reqs) or any(s is not None for s in slots):
            # ---- admission (continuous: any free slot; static: barrier)
            if not barrier or all(s is None for s in slots):
                blocked = False          # paged: FIFO head-of-line wait
                for b in range(B):
                    if blocked or slots[b] is not None:
                        continue
                    while qi < len(reqs) \
                            and reqs[qi].arrival_cycle <= cycle:
                        r = reqs[qi]
                        if paged:
                            need = pages_needed(r.prompt_len,
                                                r.max_new_tokens,
                                                self.page_size)
                            if need > n_pages:
                                raise ValueError(
                                    f"request {r.rid} needs {need} pages "
                                    f"but the pool has {n_pages}; raise "
                                    f"page_budget")
                            if not pool.can_alloc(need):
                                blocked = True
                                break
                        st = admit(r)
                        qi += 1
                        if st is not None:
                            pids = None
                            if paged:
                                pids = pool.alloc(need)
                                st["pgs"] = pids
                                tables[b, :] = 0
                                tables[b, :len(pids)] = pids
                            built["clear"](cache, b, pids)
                            slots[b] = st
                            break
            if not any(s is not None for s in slots):
                if qi < len(reqs):   # idle: jump to the next arrival
                    cycle = max(cycle + 1, reqs[qi].arrival_cycle)
                    continue
                break

            tables_t = to_dev(tables)
            pre = [b for b, st in enumerate(slots)
                   if st is not None and chunked
                   and st["pos"] < st["r"].prompt_len]
            dec = [b for b, st in enumerate(slots)
                   if st is not None and b not in pre]

            # ---- bucketed prefill chunks over the prefilling slots
            if pre:
                cmax = max(min(slots[b]["r"].prompt_len - slots[b]["pos"],
                               self.chunk_size) for b in pre)
                C = bucket_for(cmax, built["buckets"])
                ptoks = np.zeros((B, C), np.int32)
                pstart = np.zeros(B, np.int32)
                pnv = np.zeros(B, np.int32)
                who = {}
                for b in pre:
                    st = slots[b]
                    c = min(st["r"].prompt_len - st["pos"], self.chunk_size)
                    ptoks[b, :c] = st["prompt"][st["pos"]:st["pos"] + c]
                    pstart[b] = st["pos"]
                    pnv[b] = c
                    if st["pos"] + c >= st["r"].prompt_len:
                        who[b] = (st["r"].rid, 0)
                lg, cache = built["prefill"](cache, to_dev(ptoks),
                                             to_dev(pstart), to_dev(pnv),
                                             tables_t)
                nxtp = self._sample(lg, draws, who)
                for b in pre:
                    st = slots[b]
                    c = min(st["r"].prompt_len - st["pos"], self.chunk_size)
                    st["pos"] += c
                    if st["pos"] >= st["r"].prompt_len:
                        push_token(st, int(nxtp[b]))
                        if len(st["new"]) >= st["r"].max_new_tokens:
                            complete(st)
                            slots[b] = None

            # ---- one batched decode cycle over the decoding slots
            if dec:
                toks = np.zeros((B, 1), np.int32)
                idx = np.zeros(B, np.int32)
                active = np.zeros(B, bool)
                who = {}
                for b in dec:
                    st = slots[b]
                    P = st["r"].prompt_len
                    toks[b, 0] = st["prompt"][st["pos"]] if st["pos"] < P \
                        else st["last"]
                    idx[b] = st["pos"]
                    active[b] = True
                    t = st["pos"] - (P - 1)
                    if t >= 0:
                        who[b] = (st["r"].rid, t)
                logits = built["decode"](cache, to_dev(toks), to_dev(idx),
                                         to_dev(active), tables_t)
                nxt = self._sample(logits[:, 0].float(), draws, who)
                for b in dec:
                    st = slots[b]
                    if st["pos"] >= st["r"].prompt_len - 1:
                        push_token(st, int(nxt[b]))
                    st["pos"] += 1
                    if len(st["new"]) >= st["r"].max_new_tokens:
                        complete(st)
                        slots[b] = None
            cycle += 1

        wall = time.time() - t0
        ordered = tuple(results[r.rid] for r in reqs)
        return ServeReport(mode, B, ordered, cycle, wall,
                           prefill=self.prefill, kv=self.kv,
                           n_pages=built.get("n_pages", 0) if paged else 0,
                           peak_pages=pool.peak_pages if paged else 0)
