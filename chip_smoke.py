#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Run from the root of a checkout, on a machine with a CUDA card. It

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the port's CUDA kernels from the checkout's
   sources (one nvcc per source, started together), printing the build
   time and each kernel's registers and spills;
2. holds each serving attention kernel against its plain PyTorch version
   on the card: at the main path's shapes (bf16, 16 KV heads, G 1,
   head dim 64, page 16, ragged lengths, chunks of 4..32), in f32 at the
   same shapes, with GQA (G 4) and with a sliding window. Tolerance
   2e-4 in f32 (the JAX suite's attention tolerance), 2e-2 in bf16 (the
   plain version rounds its logits and output to bf16, each ~2^-8
   relative). It times each kernel, its plain version and, for the
   dense layouts, `F.scaled_dot_product_attention` on the same inputs,
   and computes each kernel's bound from the bytes and operations the
   inputs need;
3. serves qwen1.5-0.5b at full width (24 layers, d_model 1024, vocab
   151,936; random weights from --seed) with `ServeEngine`: 24 requests
   of 32-256 prompt and 16-64 new tokens on 8 slots over a fading 10 dB
   radio, greedy, first with the default paged KV and then with the
   dense one. It checks that each run went through its own two kernels,
   once per layer for every decode step and prefill chunk; that the two
   runs' bills are exactly equal; and that each request's first-chunk
   logits are finite and agree between the runs and with the
   teacher-forced `forward` (plain attention, no kernels);
4. prints one JSON line of the kernels' numbers, the card's name and
   power limit, and as the last line {"ok": true, "device": ...}.

Any failed check exits non-zero without the last line; so does a run on
a machine without CUDA, or from a directory without src/repro_torch.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12             # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# first-chunk logits against the teacher-forced forward: 8 bf16 ulps at
# the logits' scale (|logit| < 4, one ulp 2^-6); paged against dense run
# the same arithmetic in the same order, so they may differ only by the
# rounding of the K/V insert (none expected)
LOGIT_TOL, PAGED_DENSE_TOL = 0.125, 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------ timing
def device_ms(fn, copies, reps: int = 20) -> float:
    """Mean device time of one `fn(*args)`: one call per element of
    `copies` (inputs whose total exceeds L2, so each call reads its
    inputs from HBM as the serving step does) captured in a CUDA graph,
    which is replayed `reps` times between two CUDA events. The graph
    keeps the host's launch cost out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in copies:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in copies:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (reps * len(copies))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    import torch
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------- kernel checks
class Case:
    """Seeded inputs of one kernel call on the card (dense and paged
    layouts of the same K/V), with the bytes and operations the call
    needs for this data."""

    def __init__(self, rng, B, Hkv, G, S, hd, page, C, window, dtype):
        import numpy as np
        import torch
        dev = torch.device("cuda")
        self.B, self.Hkv, self.G, self.S, self.hd = B, Hkv, G, S, hd
        self.C, self.window, self.dtype = C, window, dtype
        H = Hkv * G
        qshape = (B, H, hd) if C is None else (B, C, H, hd)

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype)

        self.q = randn(*qshape)
        self.k, self.v = randn(B, Hkv, S, hd), randn(B, Hkv, S, hd)
        if C is None:       # decode: row b attends its first len[b] cols
            rows = rng.integers(1, S + 1, B)
        else:               # prefill: chunk starts on chunk boundaries
            rows = 32 * rng.integers(0, (S - C) // 32 + 1, B)
        self.rows = torch.from_numpy(rows.astype(np.int32)).to(dev)
        n_lp = S // page
        perm = rng.permutation(B * n_lp).astype(np.int32)
        self.tables = torch.from_numpy(perm.reshape(B, n_lp)).to(dev)
        tl = self.tables.long()
        self.kp = torch.empty((B * n_lp, Hkv, page, hd), dtype=dtype,
                              device="cuda")
        self.vp = torch.empty_like(self.kp)
        for src, dst in ((self.k, self.kp), (self.v, self.vp)):
            dst[tl.reshape(-1)] = src.reshape(B, Hkv, n_lp, page, hd) \
                .permute(0, 2, 1, 3, 4).reshape(B * n_lp, Hkv, page, hd)
        # what this data needs: K/V columns read, (q, k) pairs scored
        cols, pairs = 0, 0
        for r in rows.tolist():
            if C is None:
                lo = max(0, r - window) if window else 0
                cols += r - lo
                pairs += G * (r - lo)
            else:
                lo = max(0, r - window + 1) if window else 0
                cols += r + C - lo
                for c in range(C):
                    qp = r + c
                    pairs += G * (qp + 1 - (max(0, qp - window + 1)
                                            if window else 0))
        esz = self.q.element_size()
        pages = sum(math.ceil((r + (C or 0)) / page) for r in rows.tolist())
        self.nbytes = (self.q.numel() * esz + 2 * cols * Hkv * hd * esz
                       + self.q.numel() * 4 + 4 * B)
        self.nbytes_paged = self.nbytes + 4 * pages
        self.flops = 4.0 * pairs * Hkv * hd

    def kv_bytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()


def kernel_table():
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.prefill_attention import ops as pre
    from repro_torch.kernels.prefill_attention import ref as pre_ref
    kdir = "src/repro_torch/kernels"
    return [
        dict(name="decode_attention", fn=dec.gqa_decode,
             plain=dec_ref.decode_attention_ref, paged=False, prefill=False,
             source=f"{kdir}/decode_attention/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:151"),
        dict(name="paged_decode_attention", fn=dec.gqa_decode_paged,
             plain=dec_ref.paged_decode_attention_ref, paged=True,
             prefill=False,
             source=f"{kdir}/decode_attention/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:103"),
        dict(name="prefill_attention", fn=pre.gqa_prefill,
             plain=pre_ref.prefill_attention_ref, paged=False, prefill=True,
             source=f"{kdir}/prefill_attention/csrc/prefill_attention.cu",
             replaces="src/repro/kernels/prefill_attention/kernel.py:129"),
        dict(name="paged_prefill_attention", fn=pre.gqa_prefill_paged,
             plain=pre_ref.paged_prefill_attention_ref, paged=True,
             prefill=True,
             source=f"{kdir}/prefill_attention/csrc/prefill_attention.cu",
             replaces="src/repro/kernels/prefill_attention/kernel.py:81"),
    ]


def _args(kern, case):
    if kern["paged"]:
        return (case.q, case.kp, case.vp, case.tables, case.rows)
    return (case.q, case.k, case.v, case.rows)


def _sdpa(case):
    """One PyTorch call computing the dense kernel's function on the
    same inputs (SDPA with the per-row mask), and its inputs."""
    import torch
    import torch.nn.functional as F
    pos = torch.arange(case.S, device=case.q.device)
    r = case.rows[:, None].long()
    if case.C is None:
        q = case.q.reshape(case.B, case.Hkv, case.G, case.hd)
        ok = pos[None] < r
        if case.window:
            ok &= pos[None] >= r - case.window
        mask = ok[:, None, None, :]
    else:
        q = case.q.reshape(case.B, case.C, case.Hkv, case.G, case.hd) \
            .permute(0, 2, 1, 3, 4).reshape(case.B, case.Hkv,
                                            case.C * case.G, case.hd)
        qp = (r + torch.arange(case.C, device=r.device)[None]) \
            .repeat_interleave(case.G, dim=1)
        ok = pos[None, None] <= qp[..., None]
        if case.window:
            ok &= pos[None, None] > qp[..., None] - case.window
        mask = ok[:, None]
    q = q.contiguous()
    return (lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m)), (q, case.k, case.v, mask)


def check_kernels(S: int, seed: int) -> tuple:
    """Every kernel against its plain version at the main path's shapes
    and the GQA / window variants. Returns (rows for the JSON line,
    failures)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    main = dict(B=8, Hkv=16, G=1, S=S, hd=64, page=16, window=0)
    failures, out = [], []
    for kern in kernel_table():
        chunks = (4, 8, 16, 32) if kern["prefill"] else (None,)
        variants = [("main", dict(main, C=C, dtype=bf16)) for C in chunks]
        variants += [
            ("main-f32", dict(main, C=chunks[-1], dtype=f32)),
            ("gqa-g4", dict(main, Hkv=4, G=4, C=chunks[-1], dtype=f32)),
            ("window-48", dict(main, window=48, C=chunks[-1], dtype=bf16)),
            ("gqa-window-f32", dict(main, Hkv=4, G=4, window=48,
                                    C=chunks[-1], dtype=f32))]
        err_main, timed = 0.0, None
        for label, kw in variants:
            case = Case(rng, **kw)
            args = _args(kern, case)
            got = kern["fn"](*args, window=case.window)
            want = kern["plain"](*args, window=case.window).float()
            err = float((got - want).abs().max())
            tol = TOL[str(case.dtype).split(".")[1]]
            ok = bool(torch.isfinite(got).all()) and err <= tol
            tag = f"{kern['name']} {label} C={case.C} {case.dtype}"
            print(f"  check {tag}: max_abs_err {err:.3e} (tol {tol:g}) "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                failures.append(tag)
            if label == "main":
                err_main = max(err_main, err)
                ms = time_case(kern, case)
                print(f"  time  {tag}: kernel {ms['ms']:.4f} ms, plain "
                      f"{ms['plain_ms']:.4f} ms, library "
                      f"{ms['library_ms']} ms, bound {ms['bound_ms']:.4f}"
                      f" ms ({ms['bound_by']})", flush=True)
                timed = ms          # the largest chunk (32) is kept
        out.append(dict(name=kern["name"], route="cuda",
                        source=kern["source"], replaces=kern["replaces"],
                        launches=None, max_abs_err=err_main, **timed))
    return out, failures


def time_case(kern, case) -> dict:
    """Kernel, plain and library times and the bound of one main-path
    case; inputs are cycled through enough copies to exceed L2."""
    import torch
    n = max(2, math.ceil(2 * L2_BYTES / case.kv_bytes()))
    args = _args(kern, case)
    copies = [tuple(a.clone() for a in args) for _ in range(n)]
    w = case.window
    res = dict(ms=device_ms(lambda *a: kern["fn"](*a, window=w), copies),
               plain_ms=device_ms(lambda *a: kern["plain"](*a, window=w),
                                  copies),
               library_ms=None)
    if not kern["paged"]:
        fn, largs = _sdpa(case)
        res["library_ms"] = device_ms(
            fn, [tuple(a.clone() for a in largs) for _ in range(n)])
    res["bound_ms"], res["bound_by"] = bound_ms(
        case.nbytes_paged if kern["paged"] else case.nbytes, case.flops,
        case.dtype)
    del copies
    torch.cuda.empty_cache()
    return res


# -------------------------------------------------------- the main path
def serve_phase(seed: int) -> tuple:
    """Serve qwen1.5-0.5b at full width, paged then dense. Returns
    ({kernel name: launches}, summary dict, failures)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.prefill_attention import ops as pre
    from repro_torch.models import api as M
    from repro_torch.models import transformer as T
    from repro_torch.nn import count_params, init_params
    from repro_torch.schemes.radio import Radio
    from repro_torch.serve import RequestTrace, ServeEngine, make_trace

    cfg = get_arch("qwen1.5-0.5b")
    t0 = time.perf_counter()
    params = init_params(M.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(seed), "cuda")
    trace = make_trace(seed, 24, prompt_lens=(32, 256), new_tokens=(16, 64))
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{count_params(params)} params, {cfg.dtype}; init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counters = {"decode_attention": dec.gqa_decode,
                "paged_decode_attention": dec.gqa_decode_paged,
                "prefill_attention": pre.gqa_prefill,
                "paged_prefill_attention": pre.gqa_prefill_paged}
    path = {"paged": ("paged_decode_attention", "paged_prefill_attention"),
            "dense": ("decode_attention", "prefill_attention")}
    failures, launches, runs = [], {}, {}
    S = max(8, trace.max_seq_len())
    for kv in ("paged", "dense"):
        eng = ServeEngine(cfg, params, n_slots=8, greedy=True, kv=kv,
                          radio=Radio(snr_db=10.0, fading=True),
                          device="cuda")
        warm = eng.warmup_compile(trace.max_seq_len())
        built = eng.build(S)
        calls = {"decode": 0, "prefill": 0}
        firsts = []          # (chunk tokens, logits) of each first chunk
        orig = dict(built)

        def decode(*a, _f=orig["decode"]):
            calls["decode"] += 1
            return _f(*a)

        def prefill(cache, toks, st, nv, tbl, _f=orig["prefill"]):
            calls["prefill"] += 1
            lg, cache = _f(cache, toks, st, nv, tbl)
            for b in ((st == 0) & (nv > 0)).nonzero()[:, 0].tolist():
                firsts.append((toks[b, :int(nv[b])].clone(), lg[b].clone()))
            return lg, cache

        built.update(decode=decode, prefill=prefill)
        for f in counters.values():
            f.launches = 0
        rep = eng.serve(trace)
        built.update(orig)
        n = {k: f.launches for k, f in counters.items()}
        d = rep.to_dict()
        print(f"serve kv={kv}: warmup {warm:.2f} s; {d['cycles']} cycles "
              f"({calls['decode']} decode steps, {calls['prefill']} "
              f"prefill chunks), {d['generated_tokens']} tokens in "
              f"{d['wall_s']:.3f} s = {d['tokens_per_s']:.1f} tok/s; ttft "
              f"p50/p99 {d['p50_ttft_s']:.4f}/{d['p99_ttft_s']:.4f} s, "
              f"{d['p50_ttft_cycles']:.0f}/{d['p99_ttft_cycles']:.0f} "
              f"cycles; latency p50/p99 {d['p50_latency_cycles']:.0f}/"
              f"{d['p99_latency_cycles']:.0f} cycles; statuses "
              f"{d['statuses']}; launches {n}", flush=True)
        kd, kp = path[kv]
        want = {kd: cfg.n_layers * calls["decode"],
                kp: cfg.n_layers * calls["prefill"]}
        for k, v in n.items():
            if v != want.get(k, 0) or (k in want and v == 0):
                failures.append(f"kv={kv}: {k} launched {v} times, "
                                f"expected {want.get(k, 0)}")
            if k in want:
                launches[k] = v
        runs[kv] = (rep, firsts, d)
        if kv == "paged":
            prof = profile_phase(eng, RequestTrace(trace.seed,
                                                   trace.requests[:8]))

    # the bills are the same, request by request, in both layouts
    def bills(rep):
        return [(r.rid, r.status, r.bits, r.erased_bits, r.energy_j,
                 r.n_tx, r.outage_s, r.uplink_bits, r.downlink_bits)
                for r in rep.results]
    (rp, fp, dp), (rd, fd, dd) = runs["paged"], runs["dense"]
    if bills(rp) != bills(rd):
        failures.append("paged and dense bills differ")
    same_tokens = sum(a.tokens == b.tokens
                      for a, b in zip(rp.results, rd.results))
    print(f"bills equal: {bills(rp) == bills(rd)} ({dp['bits']:.0f} bits, "
          f"{dp['energy_j']:.6e} J); requests with equal tokens paged vs "
          f"dense: {same_tokens}/{len(rp.results)}", flush=True)

    # first-chunk logits: finite, paged == dense, and near forward()
    if len(fp) != len(fd) or not fp:
        failures.append(f"first chunks: {len(fp)} paged, {len(fd)} dense")
    worst_pd, worst_ref, rel = 0.0, 0.0, 0.0
    with torch.inference_mode():
        for (tp, lp), (td, ld) in zip(fp, fd):
            if not torch.equal(tp, td):
                failures.append("first chunks differ in tokens")
                break
            ref = T.forward(params, {"tokens": tp[None]}, cfg)[0][0, -1]
            ref = ref.float()
            if not (torch.isfinite(lp).all() and lp.shape == ref.shape):
                failures.append("first-chunk logits not finite / shape")
            worst_pd = max(worst_pd, float((lp - ld).abs().max()))
            worst_ref = max(worst_ref, float((lp - ref).abs().max()))
            rel = max(rel, float((lp - ref).norm() / ref.norm()))
    print(f"first-chunk logits over {len(fp)} requests: max |paged - "
          f"dense| {worst_pd:.3e} (tol {PAGED_DENSE_TOL:g}); max |paged - "
          f"forward| {worst_ref:.3e} (tol {LOGIT_TOL:g}), max relative "
          f"L2 {rel:.3e}", flush=True)
    if worst_pd > PAGED_DENSE_TOL:
        failures.append(f"paged vs dense logits differ by {worst_pd}")
    if worst_ref > LOGIT_TOL:
        failures.append(f"logits differ from forward() by {worst_ref}")
    summary = {kv: runs[kv][2] for kv in runs}
    summary.update(profile_paged_8_requests=prof,
                   first_chunk_max_abs_paged_dense=worst_pd,
                   first_chunk_max_abs_vs_forward=worst_ref,
                   first_chunk_max_rel_l2_vs_forward=rel,
                   equal_token_requests=same_tokens)
    return launches, summary, failures


def profile_phase(eng, trace) -> dict:
    """One serve of `trace` under torch.profiler, after the timed runs
    (tracing slows the host, so the end-to-end numbers come from the
    untraced runs): the share of the traced wall time in which a kernel
    ran on the card, device time by kernel, and host time by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.serve(trace)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print("profile: the profiler saw no device events (not measured)")
        return {"note": "no device events: not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    by_kernel = {}
    for e in kern:
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top_dev = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    top_host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total
                      )[:12]
    out = {"traced_wall_s": wall_us / 1e6, "cycles": rep.cycles,
           "device_busy_s": busy / 1e6,
           "device_idle_share": 1.0 - busy / wall_us,
           "device_kernels": len(kern),
           "top_device_us": {k: {"calls": n, "us": t}
                             for k, (n, t) in top_dev},
           "top_host_self_us": {a.key: {"calls": a.count,
                                        "us": a.self_cpu_time_total}
                                for a in top_host}}
    print(f"profile (paged, {len(trace.requests)} requests, traced): "
          f"{rep.cycles} cycles in {wall_us / 1e6:.3f} s, device busy "
          f"{busy / 1e6:.3f} s -> idle share {out['device_idle_share']:.3f};"
          f" {len(kern)} device events", flush=True)
    for k, (n, t) in top_dev:
        print(f"  device {t / 1e3:9.3f} ms {n:6d} x  {k[:90]}")
    for a in top_host:
        print(f"  host   {a.self_cpu_time_total / 1e3:9.3f} ms {a.count:6d} x"
              f"  {a.key[:90]}")
    return out


# ------------------------------------------------------------------ main
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every number as JSON to this file")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             f"from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    secs, logs = build.build_all()
    print(f"kernel build: {secs:.2f} s for {sorted(logs)}", flush=True)
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    from repro_torch.serve import make_trace
    S = max(8, make_trace(args.seed, 24, prompt_lens=(32, 256),
                          new_tokens=(16, 64)).max_seq_len())
    S = 16 * math.ceil(S / 16)
    print(f"kernel checks at the main path's shapes (S {S})", flush=True)
    rows, failures = check_kernels(S, args.seed)
    launches, summary, serve_failures = serve_phase(args.seed)
    failures += serve_failures
    for r in rows:
        r["launches"] = launches.get(r["name"], 0)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "kernels": rows,
                                   "serve": summary,
                                   "build_s": secs,
                                   "failures": failures}, indent=1))
    if failures:
        fail("; ".join(failures))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
