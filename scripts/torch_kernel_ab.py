#!/usr/bin/env python3
"""Time the port's packed wire (K1), conv + pool (K3), LSTM recurrence
(K4) and tiled quantize-channel (K5) kernels from two checkouts on one
CUDA card, in turns, at the paper path's shapes; the prefill attention
kernels (K9 dense, K10 paged) at chip_smoke.py phase 2's windowed shapes,
where K10 sizes its page staging by the window, and without a window at
rows that one staging holds; and the decode attention kernels (K7 dense,
K8 paged) at phase 2's decode shapes, long_500k's one row included.

    python3 scripts/torch_kernel_ab.py OLD_ROOT NEW_ROOT [--rounds 2]
                                       [--reps 20] [--only REGEX]
                                       [--out results.json]

Each turn is a fresh process with one checkout's `src` first on its
path, so it builds and loads that checkout's kernels (into the
checkout's own build/kernels/). A round runs old, new, new, old. Every
turn makes the same seeded inputs and times each kernel with the
yardstick of this repo's chip_smoke.py (`device_ms` over
`l2_copies`, inputs from `wire_inputs`, `conv_inputs`, `lstm_inputs`
and `qc_inputs`), whichever checkout it times. It prints one line per
turn and, last, a JSON summary: per kernel and shape each side's times,
the ratio of the medians new / old, and whether both checkouts gave the
same output bits. Both checkouts must have the same wrappers:
`kernels.quant_channel.ops.packed_wire_2d(buf, words, scale, p, bits)`,
`kernels.quant_channel.ops.quant_channel_2d(x, words, p, bits)`,
`kernels.quant_channel.ops.words_u32`,
`kernels.conv_pool.ops.user_conv_pool(x, w, b)`,
`kernels.lstm_cell.ops.lstm_final_state(xw, wh)` and
`kernels.prefill_attention.ops.gqa_prefill(q, k, v, start, window=)` /
`gqa_prefill_paged(q, k_pool, v_pool, tables, start, window=)` and
`kernels.decode_attention.ops.gqa_decode(q, k, v, length, window=)` /
`gqa_decode_paged(q, k_pool, v_pool, tables, length, window=)`.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WIRE_ROWS = (224, 1080)            # SL leg, FL upload (256 columns, Q8)
CONV_ROWS = (512, 2048)            # uplink batch, eval slice ([B, 30, 8])
LSTM_ROWS = (512, 2048)            # uplink batch, eval slice ([B, 14, 128])
# (B, C, KV heads, G, S, hd, window): chip_smoke.py phase 2's windowed
# prefill shapes (the main path's heads at S 272, phase 12's hd 160 and
# 128 at S 160, the long caches at 32,768), each in bf16 and f32; then
# the main path's and the long cache's without a window (2,048 pages of
# 16 at 32,768: one staging)
PREFILL_CASES = ((8, 32, 16, 1, 272, 64, 48), (8, 32, 8, 4, 160, 160, 48),
                 (8, 32, 8, 8, 160, 128, 48),
                 (4, 256, 16, 1, 32_768, 64, 8_192),
                 (4, 256, 4, 16, 32_768, 64, 8_192),
                 (8, 32, 16, 1, 272, 64, 0), (4, 256, 16, 1, 32_768, 64, 0))
# (B, KV heads, G, S, hd, window, rows): chip_smoke.py phase 2's decode
# shapes, the main path's, the long caches' on 8 ragged rows, and
# long_500k's one row of 524,288 under its window; bf16 and f32
DECODE_CASES = ((8, 16, 1, 272, 64, 0, None), (8, 16, 1, 32_768, 64, 0, None),
                (8, 4, 16, 32_768, 64, 8_192, None),
                (1, 16, 1, 524_288, 64, 8_192, (524_288,)))


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def child(root: Path, only: str, reps: int) -> None:
    """One turn: time the kernels of the checkout at `root` (those whose
    key matches the regex `only`, `reps` graph replays each), and report
    the registers and spills ptxas gave the attention kernels."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.prefill_attention import ops as pre
    from repro_torch.kernels.quant_channel import ops as qc
    res = {}

    def time_it(key, fn, copies, out):
        if re.search(only, key):
            res[key] = dict(ms=smoke.device_ms(fn, copies, reps),
                            digest=_digest(out()))

    for rows in WIRE_ROWS:
        args = smoke.wire_inputs(np.random.default_rng(rows), rows, 8)
        time_it(f"packed_wire_2d [{rows}, 256]",
                lambda *a: qc.packed_wire_2d(*a, 8), smoke.l2_copies(args),
                lambda: qc.packed_wire_2d(*args, 8))
    for B in CONV_ROWS:
        args = smoke.conv_inputs(np.random.default_rng(B), B, 30, 8, 3, 32)
        time_it(f"conv_pool [{B}, 30, 8]", cp.user_conv_pool,
                smoke.l2_copies(args), lambda: cp.user_conv_pool(*args))
    for B in LSTM_ROWS:
        args = smoke.lstm_inputs(np.random.default_rng(B), B, 14, 32)
        time_it(f"lstm_final_state [{B}, 14, 128]", lc.lstm_final_state,
                smoke.l2_copies(args),
                lambda: torch.cat(lc.lstm_final_state(*args)))
    args = smoke.qc_inputs(np.random.default_rng(5))
    time_it("quant_channel_2d [256, 512]",
            lambda *a: qc.quant_channel_2d(*a, 8), smoke.l2_copies(args),
            lambda: qc.quant_channel_2d(*args, 8))
    cases = [(f"[{B}, {C}, {hkv}, {g}, {hd}] S {S} window {w}",
              dict(B=B, Hkv=hkv, G=g, S=S, hd=hd, C=C, window=w), i,
              (("prefill_attention", pre.gqa_prefill, False),
               ("paged_prefill_attention", pre.gqa_prefill_paged, True)))
             for i, (B, C, hkv, g, S, hd, w) in enumerate(PREFILL_CASES)]
    cases += [(f"[{B}, {hkv}, {g}, {hd}] S {S} window {w}",
               dict(B=B, Hkv=hkv, G=g, S=S, hd=hd, C=None, window=w,
                    rows=rows), 100 + i,
               (("decode_attention", dec.gqa_decode, False),
                ("paged_decode_attention", dec.gqa_decode_paged, True)))
              for i, (B, hkv, g, S, hd, w, rows) in enumerate(DECODE_CASES)]
    for shape, kw, seed, kerns in cases:
        for dtype in (torch.bfloat16, torch.float32):
            keys = [f"{name} {shape} {str(dtype)[6:]}"
                    for name, _, _ in kerns]
            if not any(re.search(only, k) for k in keys):
                continue
            gen = torch.Generator(device="cuda").manual_seed(seed) \
                if kw["C"] is None else None
            case = smoke.Case(np.random.default_rng(seed), page=16,
                              dtype=dtype, gen=gen, **kw)
            for key, (_, fn, paged) in zip(keys, kerns):
                args = (case.q, case.kp, case.vp, case.tables, case.rows) \
                    if paged else (case.q, case.k, case.v, case.rows)
                call = (lambda f, w: lambda *a: f(*a, window=w))(
                    fn, kw["window"])
                time_it(key, call, [args, tuple(a.clone() for a in args)],
                        lambda: call(*args))
            del case
            torch.cuda.empty_cache()
    _, logs = build.build_all(["decode_attention", "prefill_attention"])
    regs = {fn: [n, list(spill)] for _, fn, n, spill in
            smoke.ptxas_usage(logs) if "gqa" in fn}
    print("AB " + json.dumps(res), flush=True)
    print("PTXAS " + json.dumps(regs), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20,
                    help="graph replays a timing averages over")
    ap.add_argument("--only", default="",
                    help="time only the kernels whose key matches")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.old.resolve(), args.only, args.reps)
        return
    turns, ptxas = {"old": [], "new": []}, {}
    for _ in range(args.rounds):
        for side in ("old", "new", "new", "old"):
            root = getattr(args, side).resolve()
            run = subprocess.run([sys.executable, __file__, str(root),
                                  str(root), "--child", "--only", args.only,
                                  "--reps", str(args.reps)],
                                 capture_output=True, text=True)
            line = [ln for ln in run.stdout.splitlines()
                    if ln.startswith("AB ")]
            if run.returncode or not line:
                sys.exit(f"turn {side} ({root}) failed:\n{run.stderr[-4000:]}")
            turns[side].append(json.loads(line[0][3:]))
            ptxas[side] = json.loads(next(
                ln for ln in run.stdout.splitlines()
                if ln.startswith("PTXAS "))[6:])
            print(f"{side}: " + ", ".join(
                f"{k} {v['ms']:.5f} ms" for k, v in turns[side][-1].items()),
                flush=True)
    summary = {}
    for k in turns["old"][0]:
        old = [t[k]["ms"] for t in turns["old"]]
        new = [t[k]["ms"] for t in turns["new"]]
        summary[k] = dict(
            old_ms=old, new_ms=new,
            new_over_old=statistics.median(new) / statistics.median(old),
            same_bits=len({t[k]["digest"] for s in turns.values()
                           for t in s}) == 1)
    # registers and spill bytes (stores, loads) of each attention kernel
    # instance on each side, where they differ
    summary["ptxas"] = {fn: dict(old=ptxas["old"].get(fn), new=n)
                        for fn, n in ptxas["new"].items()
                        if ptxas["old"].get(fn) != n}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
