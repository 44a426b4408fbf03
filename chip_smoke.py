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
4. holds each packed-wire kernel against its plain PyTorch version on the
   card, bit for bit (`torch.equal`): K1 `packed_wire_2d` in its three
   code widths (uint32, int8, int4) at the FL upload's [1080, 256] (3
   users x 360 rows) and the SL leg's [224, 256]; K2
   `packed_wire_mean_2d` at [1080, 256] with 3 users; K5
   `quant_channel_2d` through `ops.transmit` of an 89,673-element
   vector (the model's size); K6 `packed_wire_2d_philox` against its
   plain Philox version, its share of changed outputs at x = 0, p =
   0.05, Q8 within 0.02 of 1 - (1 - p)^8, and different from the
   host-word stream. It times each and computes its bound from the
   bytes it moves and the integer operations the wire defines;
5. trains the paper's 89,673-parameter model at full size (24,576 /
   2,560 rows, batch 512): FL (Q8, 20 dB, 3 users, J 5) for 2 cycles,
   fused SL (Q8, 20 dB, compress 4) for 1 cycle, CL for 1 cycle, with
   the launch counters set to 0 before and read after. It checks that
   FL bills exactly 8 x 89,673 = 717,384 bits per user per cycle, that
   K1 launched once per FL cycle and twice per SL training step (the SL
   eval's crossings counted apart), that the same runs on the CPU (the
   plain versions, the same draw stream, one cycle each) bill exactly
   the same, that three local steps give the same weights within 2e-5,
   and that after a cycle the train loss agrees within 2e-3 and SL's
   and CL's accuracy and test loss within 0.01 and 2e-3. FL's first
   sync is redone on the CPU from the card's uploads (bit for bit, and
   the synced model scores the same on both); FL's first cycle is rerun
   on the CPU with 1, 2, 4 and the default number of threads, and the
   card must lie within 0.01 in accuracy, 2e-3 in test-set loss and 16
   synced weights more than 1e-4 apart of the nearest of those runs
   (the CPU runs' own spread printed beside it). It traces one FL cycle
   for the device idle share;
6. prints one JSON line of the kernels' numbers, the card's name and
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
# 32-bit integer operations per second: 132 SMs x 64 INT32 lanes at the
# 1,980 MHz boost clock (NVIDIA H100 whitepaper), every operation,
# multiplies included, counted at one lane-cycle
I32_OPS_PER_S = 132 * 64 * 1.98e9
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


def bound_ms(nbytes: float, flops: float, dtype,
             int_ops: float = 0.0) -> tuple:
    """The least time of a call: bytes over HBM's rate, or its float
    operations over their peak, or its 32-bit integer operations over
    theirs (the float and integer lanes run side by side), whichever is
    longest; and which of bytes and operations that is."""
    import torch
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / peak, int_ops / I32_OPS_PER_S)
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


# ------------------------------------------------- packed-wire kernels
QC = "src/repro/kernels/quant_channel/kernel.py"
QC_SRC = "src/repro_torch/kernels/quant_channel/csrc/quant_channel.cu"
WIRE_SHAPES = {"fl_upload": 1080, "sl_leg": 224}   # rows of 256 columns
K6_P, K6_TOL = 0.05, 0.02


def wire_int_ops(bits: int) -> int:
    """32-bit integer operations the packed wire defines per element,
    counted from its plain version (ref.py), not from compiled code: per
    bit plane the XOR with the plane's constant, fmix32 (3 shifts, 3
    XORs, 2 multiplies), the compare with the threshold, and the shift
    and OR into the mask (12); per element the float-to-int conversion,
    the code offset, the mask XOR, the offset back, the two-sided clip
    and the int-to-float conversion (7). The float work (a division,
    rint, a clip, a product: 5 operations) takes less than a tenth of
    the integer time at the float rate, so it is not counted."""
    return 12 * bits + 7


# Philox4x32-10 per 32-bit word (K6): 10 rounds of 2 low and 2 high
# multiplies, 4 XORs and 2 key additions, for 4 words
PHILOX_INT_OPS_PER_WORD = 10 * (4 + 4 + 2) / 4


def _wire_inputs(rng, rows: int, bits: int, cols: int = 256):
    """Seeded packed-wire operands on the card: per-row scaled floats,
    32-bit words as int32 patterns, the wire's scale rows and p rows."""
    import numpy as np
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.kernels.quant_channel import ops as qc
    buf = (rng.standard_normal((rows, cols))
           * rng.uniform(0.01, 3.0, (rows, 1))).astype(np.float32)
    words = torch.from_numpy(rng.integers(0, 2 ** 32, (rows, cols),
                                          dtype=np.int64))
    scale = Q.scale_from_amax(torch.from_numpy(
        np.abs(buf).max(axis=1, keepdims=True)), bits)
    p = torch.from_numpy(rng.uniform(0.0, 0.1, (rows, 1))
                         .astype(np.float32))
    dev = torch.device("cuda")
    return (torch.from_numpy(buf).to(dev), qc.words_u32(words, dev),
            scale.to(dev).contiguous(), p.to(dev).contiguous())


def _timed(fn, plain, args, nbytes: float, int_ops: float) -> dict:
    """Kernel and plain device times over enough input copies to exceed
    L2, and the bound from the bytes and the integer operations."""
    import torch
    per = sum(a.numel() * a.element_size() for a in args
              if torch.is_tensor(a))
    n = max(2, math.ceil(2 * L2_BYTES / per))
    copies = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
              for _ in range(n)]
    res = dict(ms=device_ms(fn, copies), plain_ms=device_ms(plain, copies),
               library_ms=None)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 0.0, torch.float32,
                                                int_ops)
    del copies
    torch.cuda.empty_cache()
    return res


def check_wire_kernels(seed: int) -> tuple:
    """K1, K2, K5 and K6 against their plain versions on the card, bit
    for bit, at the training path's shapes; times at the FL upload's.
    Returns (rows for the JSON line, failures)."""
    import numpy as np
    import torch
    from repro_torch.core.draws import Key
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.kernels.quant_channel import ref as qref
    rng = np.random.default_rng(seed + 1)
    failures, rows = [], []

    def check(tag, got, want):
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.equal(got, want))
        print(f"  check {tag}: equal {ok} (max_abs_err {err:.3e})",
              flush=True)
        if not ok:
            failures.append(tag)
        return err

    # K1 in its three code widths at both shapes
    err1, timed1 = 0.0, None
    for wire_dtype, bits in (("float32", 8), ("int8", 8), ("int4", 4)):
        for shape, r in WIRE_SHAPES.items():
            buf, words, scale, p = _wire_inputs(rng, r, bits)
            got = qc.packed_wire_2d(buf, words, scale, p, bits,
                                    wire_dtype=wire_dtype)
            want = qref.packed_wire_ref(buf, words, scale, p, bits,
                                        wire_dtype)
            err1 = max(err1, check(f"packed_wire_2d {wire_dtype} Q{bits} "
                                   f"{shape} [{r}, 256]", got, want))
            if wire_dtype == "float32" and shape == "fl_upload":
                timed1 = _timed(
                    lambda *a: qc.packed_wire_2d(*a, 8),
                    lambda *a: qref.packed_wire_ref(*a, 8),
                    (buf, words, scale, p), r * 256 * 12 + r * 8,
                    r * 256 * wire_int_ops(8))
    rows.append(dict(name="packed_wire_2d", route="cuda", source=QC_SRC,
                     replaces=f"{QC}:147", launches=None,
                     max_abs_err=err1, **timed1))

    # K2: 3 users of 360 rows, weights 1/3
    n, r = 3, WIRE_SHAPES["fl_upload"] // 3
    buf, words, scale, p = _wire_inputs(rng, n * r, 8)
    w = torch.full((n * r, 1), 1.0 / 3.0, device="cuda")
    got = qc.packed_wire_mean_2d(buf, words, scale, p, w, 8, n)
    want = qref.packed_wire_mean_ref(buf, words, scale, p, w, 8, n)
    err2 = check("packed_wire_mean_2d Q8 3 users [1080, 256]", got, want)
    rows.append(dict(
        name="packed_wire_mean_2d", route="cuda", source=QC_SRC,
        replaces=f"{QC}:207", launches=None, max_abs_err=err2,
        **_timed(lambda *a: qc.packed_wire_mean_2d(*a, 8, n),
                 lambda *a: qref.packed_wire_mean_ref(*a, 8, n),
                 (buf, words, scale, p, w),
                 n * r * 256 * 8 + n * r * 12 + r * 256 * 4,
                 n * r * 256 * wire_int_ops(8))))

    # K5 through ops.transmit of the model's 89,673 values: the kernel
    # against its plain version at the padded [256, 512], and the whole
    # transmit on the card against the same draws on the CPU
    v = torch.from_numpy(rng.standard_normal(89_673).astype(np.float32))
    on_card = qc.transmit(Key(seed, 5).draws(), v.cuda(), 8, 10.0)
    on_cpu = qc.transmit(Key(seed, 5).draws(), v, 8, 10.0)
    err5 = check("transmit (K5) of 89,673 values, card vs CPU",
                 on_card.cpu(), on_cpu)
    x2 = torch.zeros(256 * 512, device="cuda")
    x2[:89_673] = v.cuda()
    x2 = x2.reshape(256, 512)
    w5 = qc.words_u32(Key(seed, 6).draws().words("flip", (256, 512)),
                      "cuda")
    p5 = torch.tensor([0.02], device="cuda")
    err5 = max(err5, check("quant_channel_2d Q8 [256, 512]",
                           qc.quant_channel_2d(x2, w5, p5, 8),
                           qref.quant_channel_ref(x2, w5, p5, 8)))
    rows.append(dict(
        name="quant_channel_2d", route="cuda", source=QC_SRC,
        replaces=f"{QC}:244", launches=None, max_abs_err=err5,
        **_timed(lambda *a: qc.quant_channel_2d(*a, 8),
                 lambda *a: qref.quant_channel_ref(*a, 8),
                 (x2, w5, p5), 256 * 512 * 12 + 4,
                 256 * 512 * wire_int_ops(8))))

    # K6: in-kernel Philox words
    r = WIRE_SHAPES["fl_upload"]
    zero = torch.zeros((r, 256), device="cuda")
    one = torch.ones((r, 1), device="cuda")
    pk = torch.full((r, 1), K6_P, device="cuda")
    got = qc.packed_wire_2d_philox(zero, one, pk, 8, seed=1234)
    err6 = check("packed_wire_2d_philox Q8 [1080, 256] vs plain Philox",
                 got, qref.packed_wire_philox_ref(zero, one, pk, 8, 1234))
    share = float((got != 0).float().mean())
    want_share = 1.0 - (1.0 - K6_P) ** 8
    host = qc.packed_wire_2d(zero, qc.words_u32(
        Key(seed, 7).draws().words("flip", (r, 256)), "cuda"), one, pk, 8)
    print(f"  K6 changed-output share {share:.5f} (want {want_share:.5f} "
          f"+- {K6_TOL}); differs from the host-word stream: "
          f"{not torch.equal(got, host)}", flush=True)
    if abs(share - want_share) > K6_TOL:
        failures.append(f"K6 share {share} vs {want_share}")
    if torch.equal(got, host):
        failures.append("K6 output equals the host-word stream")
    buf, _, scale, p = _wire_inputs(rng, r, 8)
    rows.append(dict(
        name="packed_wire_2d_philox", route="cuda", source=QC_SRC,
        replaces=f"{QC}:102", launches=None, max_abs_err=err6,
        **_timed(lambda *a: qc.packed_wire_2d_philox(*a, 8, 99),
                 lambda *a: qref.packed_wire_philox_ref(*a, 8, 99),
                 (buf, scale, p), r * 256 * 8 + r * 8,
                 r * 256 * (wire_int_ops(8) + PHILOX_INT_OPS_PER_WORD))))
    for row in rows:
        print(f"  time  {row['name']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})", flush=True)
    return rows, failures


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


# ----------------------------------------------------- the training path
FL_BITS_PER_USER = 8 * 89_673          # paper Table II: 0.72 Mbit
# Card vs CPU. Three local SGD steps from one init on one batch: every
# weight within STEP_TOL (the JAX suite's tiny-model tolerance). After
# one whole cycle on one draw stream: bills exactly equal, train loss
# within LOSS_TOL; SL's and CL's test accuracy and test-set loss within
# ACC_TOL / TEST_LOSS_TOL. FL's first sync is redone on the CPU from the
# card's own uploaded weights and draws: delivered and averaged weights
# bit for bit, and the synced model scored on the CPU within ACC_TOL /
# TEST_LOSS_TOL of the card's score. FL's independent trajectory: the
# FL cycle is rerun on the CPU with each of FL_THREADS intra-op threads
# and the default (another summation order each; the multi-threaded
# runs also differ from one call to the next), and the card must lie
# within ACC_TOL / TEST_LOSS_TOL / FAR_COUNT_TOL synced weights more than
# FAR_TOL apart of the nearest CPU run (on H100 machines the 1-thread
# run: accuracy equal, test loss 1.6e-5, 4 weights, in two calls). The
# CPU runs' own spread is printed beside it.
STEP_TOL = 2e-5
LOSS_TOL, ACC_TOL, TEST_LOSS_TOL = 2e-3, 0.01, 2e-3
FAR_TOL, FAR_COUNT_TOL = 1e-4, 16
FL_THREADS = (1, 2, 4)


def _wire_counters():
    from repro_torch.kernels.quant_channel import ops as qc
    return {"packed_wire_2d": qc.packed_wire_2d,
            "packed_wire_mean_2d": qc.packed_wire_mean_2d,
            "quant_channel_2d": qc.quant_channel_2d,
            "packed_wire_2d_philox": qc.packed_wire_2d_philox}


def _train_run(mode: str, cycles: int, device: str, seed: int) -> dict:
    """One scheme through `Experiment` at the paper's full size; counts
    K1 launches inside each round and inside each eval apart, times each
    cycle (round + eval) on the host clock, and scores the model's
    test-set loss after each cycle (CL, FL). FL keeps each cycle's
    upload (draw path, sent weights, delivered weights, on the host)
    and synced model."""
    import torch
    from repro_torch.configs import WirelessConfig
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.nn import tree_map
    from repro_torch.schemes import Experiment, build_scheme
    from repro_torch.schemes.base import corpus, evaluate
    wcfg = {"fl": WirelessConfig(mode="fl", quant_bits=8, snr_db=20.0,
                                 n_users=3, local_steps=5),
            "sl": WirelessConfig(mode="sl", quant_bits=8, snr_db=20.0,
                                 compress_factor=4),
            "cl": None}[mode]
    scheme = build_scheme(wcfg, device=device)
    rounds, evals, walls = [], [], []
    orig_round, orig_eval = scheme.round, scheme.evaluate

    def counted(fn, out):
        def run(*a):
            n0 = qc.packed_wire_2d.launches
            r = fn(*a)
            if device == "cuda":
                torch.cuda.synchronize()
            out.append(qc.packed_wire_2d.launches - n0)
            return r
        return run

    scheme.round = counted(orig_round, rounds)
    scheme.evaluate = counted(orig_eval, evals)
    uploads, synced = [], []
    host = lambda tr: tree_map(lambda a: a.detach().cpu().clone(), tr)
    if mode == "fl":
        send = scheme.radio.send_stacked

        def send_kept(draws, tree):
            dlv = send(draws, tree)
            uploads.append((draws.path, host(tree), host(dlv.payload)))
            return dlv
        # Radio is a frozen dataclass: shadow the method on this instance
        object.__setattr__(scheme.radio, "send_stacked", send_kept)
    t = [time.perf_counter()]

    test_losses = []

    def on_cycle(cyc, acc, rep):
        walls.append(time.perf_counter() - t[0])
        if mode != "sl":          # SL's deployed function is scored apart
            params = exp.final_state.train.trainable["model"]
            if mode == "fl":
                params = tree_map(lambda p: p[0], params)
                synced.append(host(params))
            test_losses.append(evaluate(params, *corpus()[1])[1])
        t[0] = time.perf_counter()

    exp = Experiment(scheme, cycles=cycles, seed=seed, on_cycle=on_cycle)
    res = exp.run()
    return dict(mode=mode, device=device, wcfg=wcfg, exp=exp, res=res,
                round_launches=rounds, eval_launches=evals, walls=walls,
                test_losses=test_losses, uploads=uploads, synced=synced)


def sync_check(run) -> dict:
    """The card run's first FL sync redone on the CPU (plain versions)
    from the weights the card uploaded, under the same draws: whether
    the delivered weights and their FedAvg equal the card's bit for bit,
    and how far the synced model's CPU score lies from the card's."""
    import torch
    from repro_torch.core import federated as FED
    from repro_torch.core.draws import Key
    from repro_torch.nn import tree_leaves, tree_map
    from repro_torch.schemes.base import corpus, evaluate
    from repro_torch.schemes.radio import Radio
    path, sent, got = run["uploads"][0]
    dlv = Radio.from_wcfg(run["wcfg"]).send_stacked(Key(*path).draws(), sent)
    avg = tree_map(FED.mean_users, dlv.payload)
    acc, loss = evaluate(avg, *corpus()[1])
    return dict(
        delivered_equal=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(dlv.payload), tree_leaves(got))),
        synced_equal=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(avg), tree_leaves(run["synced"][0]))),
        abs_d_accuracy=abs(acc - run["res"].accuracy[0]),
        abs_d_test_loss=abs(loss - run["test_losses"][0]))


def fl_distance(a, b) -> dict:
    """How far two FL runs lie apart after their first cycle: test
    accuracy, test-set loss, and synced weights (the count more than
    FAR_TOL apart, and the largest difference)."""
    from repro_torch.nn import tree_leaves
    d = [(x - y).abs() for x, y in zip(tree_leaves(a["synced"][0]),
                                       tree_leaves(b["synced"][0]))]
    return dict(accuracy=abs(a["res"].accuracy[0] - b["res"].accuracy[0]),
                test_loss=abs(a["test_losses"][0] - b["test_losses"][0]),
                far_weights=sum(int((x > FAR_TOL).sum()) for x in d),
                max_abs_weight=max(float(x.max()) for x in d))


def fl_cpu_runs(seed: int, threads) -> dict:
    """FL's first cycle on the CPU once per intra-op thread count in
    `threads` (the last the CPU's default), each a different summation
    order of the same arithmetic."""
    import torch
    default = torch.get_num_threads()
    runs = {}
    try:
        for n in threads:
            torch.set_num_threads(n)
            runs[n] = _train_run("fl", 1, "cpu", seed)
    finally:
        torch.set_num_threads(default)
    return runs


def train_phase(seed: int) -> tuple:
    """FL 2 cycles, SL 1, CL 1 on the card (the main path: counters set to
    0 before, read after), the same runs for one cycle on the CPU, and one
    traced FL cycle. Returns ({kernel name: launches}, summary,
    failures)."""
    from repro_torch.schemes.base import BATCH, N_TRAIN
    counters = _wire_counters()
    for f in counters.values():
        f.launches = 0
    card = {m: _train_run(m, c, "cuda", seed)
            for m, c in (("fl", 2), ("sl", 1), ("cl", 1))}
    launches = {k: f.launches for k, f in counters.items()}
    failures, summary = [], {}
    steps_sl = N_TRAIN // BATCH
    for m, run in card.items():
        res, exp = run["res"], run["exp"]
        print(f"train {m} on the card: {len(res.accuracy)} cycles, wall "
              f"per cycle {['%.3f' % w for w in run['walls']]} s; "
              f"accuracy {['%.4f' % a for a in res.accuracy]}; loss "
              f"{['%.4f' % l for l in res.loss]}; bits per cycle "
              f"{[r.bits for r in exp.reports]} (init "
              f"{exp.init_delivery.bits if exp.init_delivery else 0.0}); "
              f"K1 launches per round {run['round_launches']}, per eval "
              f"{run['eval_launches']}", flush=True)
        summary[m] = dict(wall_per_cycle_s=run["walls"],
                          accuracy=res.accuracy, loss=res.loss,
                          bits=[r.bits for r in exp.reports],
                          steps=[r.steps for r in exp.reports],
                          k1_round_launches=run["round_launches"],
                          k1_eval_launches=run["eval_launches"])
    fl = card["fl"]
    for r in fl["exp"].reports:
        if r.bits / 3 != FL_BITS_PER_USER:
            failures.append(f"FL billed {r.bits / 3} bits per user per "
                            f"cycle, not {FL_BITS_PER_USER}")
    if fl["round_launches"] != [1, 1]:
        failures.append(f"FL K1 launches per cycle {fl['round_launches']}")
    sl = card["sl"]
    if sl["round_launches"] != [2 * steps_sl] or \
            sl["exp"].reports[0].steps != steps_sl:
        failures.append(f"SL K1 launches {sl['round_launches']} for "
                        f"{sl['exp'].reports[0].steps} steps")
    if sl["eval_launches"] != [1]:
        failures.append(f"SL eval K1 launches {sl['eval_launches']}")
    if card["cl"]["round_launches"] != [0]:
        failures.append("CL launched the wire kernel")
    for k in ("packed_wire_mean_2d", "quant_channel_2d",
              "packed_wire_2d_philox"):
        if launches[k]:
            failures.append(f"{k} launched on the training path")
    for m, run in card.items():
        for a, l in zip(run["res"].accuracy, run["res"].loss):
            if not (math.isfinite(a) and math.isfinite(l)):
                failures.append(f"{m}: non-finite accuracy or loss")

    # the same draw stream on the CPU: identical bills, close training
    import torch
    fl_cpu = fl_cpu_runs(seed, sorted(set(FL_THREADS)
                                      | {torch.get_num_threads()}))
    n_cpu = torch.get_num_threads()

    def bills(run):
        init = run["exp"].init_delivery
        return ([(r.bits, r.n_tx, r.erased_bits, r.energy_j)
                 for r in run["exp"].reports[:1]],
                init.bits if init else 0.0)

    for m in ("fl", "sl", "cl"):
        c = card[m]
        h = fl_cpu[n_cpu] if m == "fl" else _train_run(m, 1, "cpu", seed)
        same = bills(c) == bills(h)
        if m == "fl":
            same = same and all(bills(c) == bills(r)
                                for r in fl_cpu.values())
        da = abs(c["res"].accuracy[0] - h["res"].accuracy[0])
        dl = abs(c["res"].loss[0] - h["res"].loss[0])
        dt = abs(c["test_losses"][0] - h["test_losses"][0]) \
            if m != "sl" else 0.0
        held = "" if m == "fl" else (f", |d accuracy| {da:.5f} (tol "
                                     f"{ACC_TOL}), |d test loss| {dt:.2e} "
                                     f"(tol {TEST_LOSS_TOL})")
        print(f"train {m} card vs CPU (cycle 0, {n_cpu} threads): bills "
              f"equal {same}; |d train loss| {dl:.2e} (tol {LOSS_TOL})"
              f"{held}; CPU wall {h['walls'][0]:.2f} s", flush=True)
        summary[m].update(cpu_bills_equal=same, cpu_abs_d_accuracy=da,
                          cpu_abs_d_loss=dl, cpu_abs_d_test_loss=dt,
                          cpu_wall_s=h["walls"][0])
        if not same:
            failures.append(f"{m}: card and CPU bills differ")
        if dl > LOSS_TOL:
            failures.append(f"{m}: card vs CPU train loss {dl}")
        if m != "fl" and (da > ACC_TOL or dt > TEST_LOSS_TOL):
            failures.append(f"{m}: card vs CPU accuracy {da} / test loss "
                            f"{dt}")
    fl_summary, fl_failures = fl_checks(card["fl"], fl_cpu)
    summary["fl"].update(fl_summary)
    failures += fl_failures
    gap = step_gap(seed)
    print(f"three local SGD steps, card vs CPU: max |d weight| {gap:.3e} "
          f"(tol {STEP_TOL})", flush=True)
    summary["three_step_max_abs_weight_gap"] = gap
    if not gap <= STEP_TOL:
        failures.append(f"three local steps: card vs CPU weights {gap}")
    summary["profile_fl_cycle"] = profile_train(seed)
    return launches, summary, failures


def fl_checks(card, cpu_runs) -> tuple:
    """FL after its first sync: the sync redone on the CPU from the
    card's uploads (bit for bit; the same model scored on both within
    ACC_TOL / TEST_LOSS_TOL), and the card's independent trajectory
    against the nearest of `cpu_runs` (thread count -> run).
    Returns (summary, failures)."""
    failures = []
    sync = sync_check(card)
    print(f"train fl first sync redone on the CPU from the card's uploads: "
          f"delivered equal {sync['delivered_equal']}, synced equal "
          f"{sync['synced_equal']}; synced model scored on the CPU: "
          f"|d accuracy| {sync['abs_d_accuracy']:.5f} (tol {ACC_TOL}), "
          f"|d test loss| {sync['abs_d_test_loss']:.2e} (tol "
          f"{TEST_LOSS_TOL})", flush=True)
    if not (sync["delivered_equal"] and sync["synced_equal"]):
        failures.append("FL sync on the card differs from the CPU's")
    if sync["abs_d_accuracy"] > ACC_TOL or \
            sync["abs_d_test_loss"] > TEST_LOSS_TOL:
        failures.append(f"FL synced model scores apart on card and CPU "
                        f"{sync}")
    threads = sorted(cpu_runs)
    spread = {f"{a}v{b}": fl_distance(cpu_runs[a], cpu_runs[b])
              for i, a in enumerate(threads) for b in threads[i + 1:]}
    to_card = {str(n): fl_distance(card, r) for n, r in cpu_runs.items()}
    tol = dict(accuracy=ACC_TOL, test_loss=TEST_LOSS_TOL,
               far_weights=FAR_COUNT_TOL)
    for k, t in tol.items():
        widest = max(d[k] for d in spread.values())
        nearest = min(d[k] for d in to_card.values())
        print(f"train fl {k}: card to the nearest CPU run {nearest:.6g} "
              f"(tol {t}); card to each of {threads} threads "
              f"{[round(to_card[str(n)][k], 6) for n in threads]}; the CPU "
              f"runs apart by up to {widest:.6g}", flush=True)
        if nearest > t:
            failures.append(f"FL {k}: card {nearest} from the nearest CPU "
                            f"run, beyond {t}")
    return dict(sync_redone_on_cpu=sync, cpu_spread=spread,
                card_to_cpu=to_card), failures


def step_gap(seed: int) -> float:
    """Largest weight difference between the card and the CPU after
    three local SGD steps (lr 0.1) from one init on the corpus' first
    batch."""
    import torch
    from repro_torch.nn import tree_leaves
    from repro_torch.runtime.train_step import (init_train_state,
                                                make_local_step)
    from repro_torch.schemes.base import BATCH, CFG, MOMENTUM, corpus
    (xtr, ytr), _ = corpus()
    out = {}
    for dev in ("cuda", "cpu"):
        st = init_train_state(torch.Generator().manual_seed(seed), CFG,
                              None, "sgd", MOMENTUM, dev)
        step = make_local_step(CFG, 0.1, MOMENTUM)
        b = {"tokens": torch.from_numpy(xtr[:BATCH]).to(dev),
             "labels": torch.from_numpy(ytr[:BATCH]).to(dev)}
        for _ in range(3):
            st, _m = step(st, b)
        out[dev] = tree_leaves(st.trainable)
    return max(float((a.cpu() - b).abs().max())
               for a, b in zip(out["cuda"], out["cpu"]))


def profile_train(seed: int) -> dict:
    """One FL cycle (the paper's full size) under torch.profiler: the
    share of the traced wall time in which no kernel ran on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import WirelessConfig
    from repro_torch.schemes import Experiment, build_scheme
    scheme = build_scheme(WirelessConfig(mode="fl", quant_bits=8),
                          device="cuda")
    exp = Experiment(scheme, cycles=1, seed=seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _idle_summary(prof, wall_us, "FL cycle")


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
    out = _idle_summary(prof, wall_us,
                        f"paged serve, {len(trace.requests)} requests")
    out["cycles"] = rep.cycles
    return out


def _idle_summary(prof, wall_us: float, label: str) -> dict:
    """Device busy time (union of kernel spans), idle share of the traced
    wall time, device time by kernel and host self time by op."""
    import torch
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print(f"profile {label}: the profiler saw no device events "
              f"(not measured)")
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
    out = {"traced_wall_s": wall_us / 1e6,
           "device_busy_s": busy / 1e6,
           "device_idle_share": 1.0 - busy / wall_us,
           "device_kernels": len(kern),
           "top_device_us": {k: {"calls": n, "us": t}
                             for k, (n, t) in top_dev},
           "top_host_self_us": {a.key: {"calls": a.count,
                                        "us": a.self_cpu_time_total}
                                for a in top_host}}
    print(f"profile ({label}, traced): {wall_us / 1e6:.3f} s, device busy "
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
    print("packed-wire kernel checks at the training path's shapes",
          flush=True)
    wire_rows, wire_failures = check_wire_kernels(args.seed)
    failures += wire_failures
    launches, summary, serve_failures = serve_phase(args.seed)
    failures += serve_failures
    for r in rows:
        r["launches"] = launches.get(r["name"], 0)
    t_train = time.perf_counter()
    train_launches, train_summary, train_failures = train_phase(args.seed)
    print(f"training phase: {time.perf_counter() - t_train:.1f} s; "
          f"launches on the training path {train_launches}", flush=True)
    failures += train_failures
    for r in wire_rows:
        r["launches"] = train_launches.get(r["name"], 0)
    rows += wire_rows
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "kernels": rows,
                                   "serve": summary,
                                   "train": train_summary,
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
