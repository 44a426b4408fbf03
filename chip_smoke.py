#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Run from the root of a checkout, on a machine with a CUDA card. It

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the port's CUDA kernels from the checkout's
   sources (one nvcc per source, started together), printing the build
   time and each kernel function's registers and spills; a spill in the
   decode / prefill kernels of namespace `gqa` (dense and paged
   instances, both of which must be there), the packed wire, conv + pool
   or the LSTM fails the run. It times the harness's own per-launch floor (a
   one-element add_ per call in the CUDA graph `device_ms` replays);
2. holds each serving attention kernel against its plain PyTorch version
   on the card: at the main path's shapes (bf16, 16 KV heads, G 1,
   head dim 64, page 16, ragged lengths, chunks of 4..32), in f32 at the
   same shapes, with GQA (G 4), with a sliding window and at phase 12's
   head shapes (hd 128 at G 5, 8, 12 and 16; hd 64 at G 16; hd 160 at
   G 4; the last two also with a window). Tolerance
   2e-4 in f32 (the JAX suite's attention tolerance), 2e-2 in bf16
   against the plain version in f32 arithmetic on the same bf16 inputs
   (in bf16 the plain version rounds its logits and output to bf16 and
   is itself up to ~0.016 from that at outputs near 4; its gap is
   printed beside). Every variant is run twice and must give the same bits,
   and each paged kernel must give its dense twin's bits on the same
   data (K8 = K7, K10 = K9: one body each, templated on the addressing).
   It prints the decode kernels' split count, times each kernel, the
   dense decode kernel also at split counts 1-9, its plain version and,
   for the dense layouts, `F.scaled_dot_product_attention` on the same
   inputs (beside each paged kernel: its dense twin and SDPA on the
   dense copy of its data), and computes each kernel's bound from the
   bytes and operations the inputs need;
3. serves qwen1.5-0.5b at full width (24 layers, d_model 1024, vocab
   151,936; random weights from --seed) with `ServeEngine`: 24 requests
   of 32-256 prompt and 16-64 new tokens on 8 slots over a fading 10 dB
   radio, greedy, first with the default paged KV and then with the
   dense one. It checks that each run went through its own two kernels,
   once per layer for every decode step and prefill chunk; that the two
   runs' bills are exactly equal; that both runs generate the same
   greedy tokens in every request and the same first-chunk logits, bit
   for bit; and that each request's first-chunk logits are finite and
   lie within LOGIT_TOL of the teacher-forced `forward` (plain
   attention, no kernels). It traces 2 requests of each run (at most 8
   new tokens each) for the device's idle share and the attention
   kernels' share of the busy time (a kernel name that matches no
   traced kernel fails the run);
4. holds each packed-wire kernel against its plain PyTorch version on the
   card, bit for bit (`torch.equal`): K1 `packed_wire_2d` in its three
   code widths (uint32, int8, int4) at the FL upload's [1080, 256] (3
   users x 360 rows) and the SL leg's [224, 256], the float32 wire also
   at Q16 and Q32 (Fig. 3's bits: the top level saturates as in XLA); K2
   `packed_wire_mean_2d` at [1080, 256] with 3 users at Q8 and Q32; K5
   `quant_channel_2d` through `ops.transmit` of an 89,673-element
   vector (the model's size), and at [256, 512] at Q8 and Q32; K6
   `packed_wire_2d_philox` at Q32 and Q8 against its
   plain Philox version, its share of changed outputs at x = 0, p =
   0.05, Q8 within 0.02 of 1 - (1 - p)^8, and different from the
   host-word stream. It times each (K1 at both shapes; K5 with its
   launch geometry) and
   computes its bound from the bytes it moves and the integer
   operations the wire defines;
5. trains the paper's 89,673-parameter model at full size (24,576 /
   2,560 rows, batch 512): FL (Q8, 20 dB, 3 users, J 5) for 2 cycles,
   fused SL (Q8, 20 dB, compress 4) for 1 cycle, CL for 1 cycle, with
   the launch counters set to 0 before and read after (FL records the
   privacy capture, which phase 7 reads; K1's, K3's and K4's launches
   are also counted by input shape, here and in phase 7). It checks that
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
   (the CPU runs' own spread printed beside it). It checks that every
   eval (one slice of 2,048 test rows) launched K3 and K4 once each and
   that no training round launched either. It traces one FL cycle for
   the device idle share;
6. holds the tiny model's kernels against their plain versions on the
   card within 2e-5 abs + rel (the JAX suite's tolerance): K3
   `user_conv_pool` at the eval slice [2048, 30, 8], a batch [512, 30,
   8] and ragged B 1 and 7 and T 29; K4 `lstm_final_state` at [2048, 14,
   128], [512, 14, 128], B 1, 7 and 33, T 1 and 30, H 8, 16, 24 (its
   register body, at one and two rows a lane) and 48 (its shared-memory
   body); both must give the same bits twice. It times both at the eval
   slice and the uplink batch (K4 also at one and two rows a lane, with
   its launch geometry) beside their bounds and plain versions, and the
   library's nearest calls: conv1d -> relu -> max_pool1d (three calls)
   for K3, one cuDNN `nn.LSTM` call (input product included, against
   `lstm_layer`) for K4;
7. drives the privacy study and two-party SL at full size, counters set
   to 0 before and read after: two-party SL (Q8, 20 dB, compress 4),
   fused SL (Q16, 20 dB, compress 4, capture every 8 steps) and CL over a
   20 dB link, one cycle each, with capture. It checks the launches per
   round and eval (K3 once per two-party uplink and per capture step, K3
   and K4 once per eval slice, neither under autograd), the two-party
   bills against the same run on the CPU bit for bit and its loss and
   accuracy within phase 5's gates, and the captures' shapes; then it
   takes the Table II rows from `repro_torch.launch.table2.rows_from_runs`
   on these captures and phase 5's FL captures (CL direct read, FL
   statistic and per-sample protocols, SL 600 adversary steps; the SL
   adversary also on the CPU from the same draws: within 5 % relative)
   and requires err_SL > err_CL; it prints the entry point's Table II
   lines (`fl_q8_extra`, the paper-scale bits and the seven claims
   included) and the two-party SL row;
7b. runs the paper's Fig. 3 through `repro_torch.launch.fig3` on the
   card, counters set to 0 before and read after: all four panels (3a
   CL, FL Q8 / Q32, SL Q16; 3b FL Q4-Q32; 3c CL, FL, FL with ARQ and SL
   at 0 / 10 / 20 / 30 dB; 3d CL clean and fading, FL, SL) at one cycle
   a run on 3,072 / 512 rows. It checks the JAX scripts' line names
   (benchmarks/accuracy_cycles.py, quant_sweep.py, snr_sweep.py,
   fading.py), every bill against its closed form (FL with ARQ: the
   width x the packet sizes x the drawn n_tx), every run's K1 / K3 / K4
   launches per round and eval against the path's, finite scores, and
   FL Q32 rerun on the CPU: equal bills, accuracy within 0.01 and train
   loss within 2e-3;
8. serves the paper's classifier (paper-tinylstm, phase 5's CL-trained
   weights) with `ServeEngine` on the card: 256 requests of 30-token
   prompts, 1 new token each (the class) and 4 for every fourth, 32
   slots, 8 arrivals a cycle, a 10 dB fading radio, greedy, paged KV
   asked for. It checks that the engine serves dense, that no attention
   kernel (K7-K10) launched, that each served request's class logit
   lies within 2e-5 abs + rel of `lstm_tiny.forward` on the same tokens
   on the card (K3 + K4, which must launch), and that the same trace on
   the CPU gives exactly the same bills and the same tokens and TTFT
   cycles except at listed near-ties (|z| < 4e-5); it prints requests/s,
   TTFT p50/p99 and the idle share of a traced serve of 64 requests;
9. runs the FL/SL options at full size, one cycle each on the card:
   FL with the coordinate median (the sync redone on the CPU from the
   card's uploads, bit for bit), DP-FedAvg (sigma 0.5, C 1: K1 three
   times a cycle, 3 x 717,384 bits, epsilon 9.6896; the sync redone on
   the CPU: at most 64 Q8 codes moved by one step, the synced weights
   within one step / 3), Dirichlet(0.1) shards + FedProx (mu 0.1) +
   sampling with replacement (three local steps within 2e-5 of the
   CPU), phase 5's fused SL model scored over the noiseless link
   (`perfect_eval`, within 0.01 of the CPU), and the model's 89,673
   weights through Hamming(7,4) and each constellation at Q8, 5 dB
   (bit for bit with the CPU on the same draws); it prints each
   option's seconds beside the card;
10. runs fleets, faults and resume on the card (benchmarks/fleet.py's
   corpus, 4,096 / 512 rows): its two parity fleets (parity_mixed_4:
   FL Q8 20 dB, FL Q4 6 dB, SL Q16 12 dB, SL Q8 20 dB, 2 cycles;
   parity_faulty_6: bounded ARQ with Gilbert-Elliott and backoff,
   Bernoulli(0.8), quorum 0.3, a FaultPlan, 3 cycles) under
   `PopulationScheme` and `FleetScheme`, the loop also on the CPU:
   every round's bill equal between the engines and card = CPU, bit for
   bit, the last round's per-client detail too, accuracy within 0.01 of
   the CPU, parity_mixed_4 at 6,581,100 bits a round (the JAX package's
   number), K1 once per FL group and twice per SL step in each round,
   K3 and K4 once per eval slice; then kill-and-resume at the full
   corpus (tests/test_resume.py's faulty FL, and parity_mixed_4 under a
   FaultPlan, 4 cycles killed at 2): accuracies, losses, total bits,
   every report and every state tensor equal to the uninterrupted run
   (`torch.equal`); then the synthetic billing plane at 10^4 (3 rounds)
   and 10^5 (2 rounds) clients, printing seconds per round, the SL
   replay's share, n_active, bits and erased bits, with one 10^4 round
   again on the CPU, bit for bit. No attention kernel may launch;
11. trains qwen1.5-0.5b at full width and depth (24 layers, d_model
   1024, vocab 151,936; random weights from --seed) through the scaled
   schemes on the synthetic Zipf corpus (512 / 128 rows, seq 128, batch
   8, lr 3e-4), counters set to 0 before and read after: CL (AdamW,
   corpus over 20 dB) and SL (split 2, compress 4, Q8, 20 dB, AdamW), 2
   cycles of 5 steps; FL (3 users, J 5, Q8, 20 dB, SGD) one barrier
   cycle through K1, one through K2 (`use_kernel`) and 2 delayed cycles
   at Q4 on the int4 wire. SL and the K2 cycle run through the training
   CLI (`launch.train --arch qwen1.5-0.5b --mode sl|fl ...`), the others
   through `build_scheme` + `Experiment`. It checks the bills (FL 3,711,901,696 bits a
   user a Q8 cycle, 1,855,950,848 at int4, n_tx 42; SL 4,194,304 a step;
   CL's corpus 1,179,648 once), K1 twice a SL step at [1024, 256] and
   once an eval slice (counted apart), K1 once a K1 FL cycle at the
   sync's [5,437,368, 256], K2 once a K2 cycle, no K3-K10 launch, every
   loss finite and CL's and SL's last-cycle loss below their first
   step's; it prints each run's seconds per cycle, the sync's seconds
   and its host flip-word draws, the peak RSS, `max_memory_allocated`,
   and the idle share of a traced CL step and FL cycle. Then the same
   schemes at the reduced config on the card and the CPU (bills equal,
   losses within 2e-3, accuracy within 0.01, an FL cycle's uploads
   synced through K1 and K2 bit for bit with the CPU), and K2 at one
   stacked [24, 1024, 1024] leaf of the sync (3 x 98,304 rows) and K1
   at the SL leg against their plain versions, timed beside their
   bounds; and K1 and K2 at the whole sync, [5,437,368, 256], timed and
   held against their plain versions bit for bit, 65,536 rows a slab;
12. serves the moe family and the wide-head dense configs at full width
   (random weights from --seed), paged then dense, 8 slots, greedy,
   chunk 32, page 16, a fading 10 dB radio, `make_trace(seed, n,
   prompt_lens=(32, 128), new_tokens=(8, 32))`: qwen3-moe-235b-a22b (hd
   64, 128 experts top-8) at 4 of 94 layers, 16 requests;
   llama4-scout-17b-a16e (hd 128, G 5, 16 experts top-1 + shared) at 2
   of 48, chatglm3-6b (hd 128, G 16) at its full 28,
   command-r-plus-104b (hd 128, G 12, parallel block) at 2 of 64,
   stablelm-12b (hd 160, G 4, layernorm) at its full 40 and
   internvl2-76b (hd 128, G 8; served on tokens, as the JAX engine
   serves it) at 4 of 80, 8 requests each. It checks each run's two kernels once per layer per
   decode step and prefill chunk, paged = dense bills, tokens and
   first-chunk logits bit for bit, and the first-chunk logits finite and
   within 8 bf16 ulps at the largest |logit| of a plain reference: the
   teacher-forced `forward` for the dense configs; for MoE, whose
   capacity makes a result depend on the tokens that share a call, the
   fused `prefill_step` with the plain attention on the same chunk and
   cache (routing swaps accepted within ROUTER_TIE router logits). It
   prints tok/s, TTFT, the MoE's mean dropped fraction at prefill and
   decode (decode must drop none), max_memory_allocated, and a traced
   serve's idle share and busy time split into expert products, casts
   and attention. Then qwen3-moe-235b-a22b and llama4-scout-17b-a16e at
   `reduced()` through the scaled CL, SL and FL (K1) schemes, one cycle
   each on the card and the CPU: bills equal, losses within 2e-3,
   accuracy within 0.01, every CL / SL step's load-balance loss finite
   and > 0, K1 by shape, no K3-K10 launch. Phase 2 also holds K7-K10 at
   these configs' heads (KV heads, G, hd: 4, 16, 64; 8, 5, 128; 2, 16,
   128; 8, 12, 128) against their plain versions, paged = dense, and
   times them (`by_shape`, with the launches of each config's serving);
13. drives the ssm family at full width and depth (xlstm-350m: 24
   layers, 4 super-blocks of 5 mLSTM + 1 sLSTM, d_model 1024, 4 heads at
   hd 256, vocab 50,304; random weights from --seed), counters set to 0
   before and read after: `launch.serve --arch xlstm-350m` (the billed
   static loop, 4 users x 32 prompt + 16 new tokens, 10 dB fading,
   greedy): the prompt's decode logits within 8 bf16 ulps at the largest
   |logit| of the teacher-forced `forward` (its bf16 products reducing
   in f32; the gap to it with cuBLAS's default bf16 split-K reductions is
   printed beside), the bill exactly the two crossings' token bits and
   energy, no kernel launched; then the scaled
   CL and SL (AdamW, 2 steps, split at super-block 2) through
   `build_scheme` + `Experiment` and FL (3 users x 1 local step, the K1
   sync) through `launch.train --arch xlstm-350m --mode fl`, one cycle
   each on the training CLI's corpus (512 training rows, batch 8, seq
   128; 32 held-out rows, 4 eval slices):
   bills exact (CL's corpus 1,048,576 bits once; SL 4,194,304 a step;
   FL 8 bits a parameter a user, n_tx 3 x 17 leaves), every loss finite,
   CL's and SL's second step's loss below the first's, K1 twice an SL
   step and once an SL eval slice and once an FL cycle, no K3-K10
   launch; it prints seconds per round and eval, the sync's host
   flip-word seconds, max_memory_allocated and a traced eval slice's
   idle share. Then internvl2-76b and xlstm-350m at `reduced()` through
   the scaled CL, SL (2 steps) and FL (K1; 2 local steps) schemes, card
   against CPU as phase 12's MoE runs;
14. drives the hybrid and audio families at full width and depth
   (zamba2-1.2b: 38 Mamba2 blocks, 6 super-blocks of 6 + a tail of 2,
   the shared attention + MLP block after each super-block, d_model
   2048, 32 heads at hd 64, SSM state 64; seamless-m4t-medium: 12 + 12
   layers, d_model 1024, 16 heads at hd 64, layernorm, vocab 256,256;
   random weights from --seed), counters set to 0 before each part and
   read after: `launch.serve` (the billed static loop as in phase 13;
   seamless first encodes the stub frames, 0.1 everywhere, into its
   cross-attention cache): the prompt's decode logits within 16
   (zamba2, whose gap to the forward it prints block by block: it grows
   through the Mamba2 stack) and 8 (seamless) bf16 ulps of the
   teacher-forced `forward` (f32 reductions), the bill exactly the two
   crossings', K7 6 (zamba2) and 24 (seamless) times a decode step and
   no other kernel; then scaled CL and SL (AdamW, 2 steps; zamba2 cut
   at super-block 2, seamless at the encoder output, frames [8, 512,
   1024]) on the training CLI's corpus: bills exact (CL 983,040 and
   1,179,648 bits once; SL 8,388,608 and 16,777,216 a step), losses
   finite and falling, K1 twice an SL step and once an SL eval slice, no
   K3-K10; seconds per round and eval, max_memory_allocated and a traced
   eval slice's idle share. Then both at `reduced()` through the scaled
   CL, SL and FL (K1) schemes, card against CPU as phase 12's MoE runs.
   Phase 2 also holds K7 at the static loop's decode shapes (4 rows;
   KV heads / cache 32 / 48, 16 / 48, 16 / 512) and times two of them;
15. drives the mesh and compile machinery (P16): qwen1.5-0.5b at full
   width, SL (split 2, one step, 16 / 8 rows), through
   `python -m repro_torch.launch.train` in two processes that share one
   fresh kernel-build cache (`REPRO_TORCH_KERNEL_CACHE_DIR`): first
   `--mesh test --aot-warmup` (cold: `nvcc` builds K1's library), then
   `--mesh none --aot-warmup` (warm: it is found). It checks warm <
   0.2 x cold (the JAX package's gate on its compile cache), the two
   runs' bills, losses and accuracy equal bit for bit, and K1 launched
   three times in each (two legs, one eval slice). On phase 11's live SL
   scheme, `lower_step(make_test_mesh())`'s argument bytes must equal the
   bytes of its state and a batch on the card (printed beside
   `max_memory_allocated`). Then `launch.serve --arch qwen1.5-0.5b
   --mesh test --aot-warmup` on 4 requests must give the same tokens and
   bills as the same trace without a mesh, through K8 and K10;
16. prints one JSON line of the kernels' numbers (K1-K6, K3 and K4 with
   their launches over phases 5 and 7-15 together, K7-K10 over phases 3,
   12, 14 and 15; K1-K4 and K7-K10 also per timed shape, under
   "by_shape"), the card's name and power limit, and as the last line
   {"ok": true, "device": ...}.

Any failed check exits non-zero without the last line; so does a run on
a machine without CUDA, or from a directory without src/repro_torch.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import functools
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12             # f32 outside the tensor cores
# instructions per second, in lanes: 132 SMs x 4 schedulers x 32 lanes
# at the 1,980 MHz boost clock (NVIDIA H100 whitepaper). Integer work
# shares two pipes, the ALU (logic, shifts, compares, adds) and the FMA
# pipe (IMAD, and shifts or moves the compiler issues as IMAD), so no one
# pipe's rate bounds it; the schedulers' issue rate does
ISSUE_LANES_PER_S = 132 * 4 * 32 * 1.98e9
L2_BYTES = 50 * 2 ** 20
# against the plain version in f32 on the same inputs (`_f32`)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# first-chunk logits against the teacher-forced forward: 8 bf16 ulps at
# the logits' scale (|logit| < 4, one ulp 2^-6). Paged against dense is
# checked at this bound and, more strictly, for equal bits: the paged
# kernels run the dense kernels' bodies in the same order
LOGIT_TOL = 0.125


# libraries none of whose kernels may spill (besides the attention
# kernels of namespace `gqa`): the packed wire, conv + pool and the LSTM
NO_SPILL_LIBS = ("quant_channel", "conv_pool", "lstm_cell")


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


def l2_copies(args) -> list:
    """Enough copies of `args` (tensors cloned, other values shared) that
    together they exceed L2 twice over, for `device_ms`."""
    import torch
    per = sum(a.numel() * a.element_size() for a in args
              if torch.is_tensor(a))
    return [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            for _ in range(max(2, math.ceil(2 * L2_BYTES / per)))]


def bound_ms(nbytes: float, flops: float, dtype,
             int_ops: float = 0.0) -> tuple:
    """The least time of a call: bytes over HBM's rate, or its float
    operations over their peak, or its integer instructions (a lower
    count) over the issue rate, whichever is longest; and which of bytes
    and operations that is."""
    import torch
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / peak, int_ops / ISSUE_LANES_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ptxas_usage(logs: dict) -> list:
    """(library, kernel function, registers, (spill store, spill load
    bytes)) for every kernel in the `nvcc -Xptxas -v` logs."""
    import re
    rows = []
    for lib, text in sorted(logs.items()):
        fn, spill = None, (0, 0)
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "spill stores" in line:
                spill = tuple(int(x) for x in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", line))
            elif "Used" in line and "registers" in line and fn:
                regs = int(re.search(r"Used (\d+) registers", line)[1])
                rows.append((lib, fn, regs, spill))
                fn, spill = None, (0, 0)
    return rows


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
             prefill=False, twin="decode_attention",
             source=f"{kdir}/decode_attention/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:103"),
        dict(name="prefill_attention", fn=pre.gqa_prefill,
             plain=pre_ref.prefill_attention_ref, paged=False, prefill=True,
             source=f"{kdir}/prefill_attention/csrc/prefill_attention.cu",
             replaces="src/repro/kernels/prefill_attention/kernel.py:129"),
        dict(name="paged_prefill_attention", fn=pre.gqa_prefill_paged,
             plain=pre_ref.paged_prefill_attention_ref, paged=True,
             prefill=True, twin="prefill_attention",
             source=f"{kdir}/prefill_attention/csrc/prefill_attention.cu",
             replaces="src/repro/kernels/prefill_attention/kernel.py:81"),
    ]


def _f32(args) -> tuple:
    """`args` with every floating tensor in float32: the plain version on
    the same values in f32 arithmetic, the bf16 kernels' yardstick (in
    bf16 the plain version rounds its logits and its output to bf16,
    ~2^-9 relative each, up to 0.016 at outputs near 4, measured on the
    CPU at hd 160: the yardstick's own error; against f32 arithmetic a
    bf16 kernel's only rounding is P to bf16 before P.V, ~0.004 there)."""
    import torch
    return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


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


# the attention shapes (KV heads, group G, head dim) of phase 12's served
# configs: qwen3-moe-235b-a22b, llama4-scout-17b-a16e, chatglm3-6b,
# command-r-plus-104b, stablelm-12b (hd 160: the decode body's 20-lane
# columns, the bf16 prefill's padded 21-chunk rows, the f32 body's
# 16-column tiles) and internvl2-76b. G 5 and 12 leave partial head-group
# blocks (decode) and partial 16-row groups (prefill: C * G rows)
WIDE_HEADS = ((4, 16, 64), (8, 5, 128), (2, 16, 128), (8, 12, 128),
              (8, 4, 160), (8, 8, 128))
# the heads added with stablelm-12b and internvl2-76b, checked also with a
# sliding window (bf16 and f32)
WINDOWED_HEADS = ((8, 4, 160), (8, 8, 128))
# the static serving loop's decode calls (phase 14, 4 rows, hd 64, G 1):
# (KV heads, cache length) of zamba2-1.2b's shared attention and of
# seamless-m4t-medium's self- and cross-attention; the first and the last
# are timed (the by_shape key has no cache length)
STATIC_DECODE = ((32, 48), (16, 48), (16, 512))
STATIC_TIMED = ("static-hkv32-s48", "static-hkv16-s512")


def _shape_key(kern, case) -> list:
    """A kernel's by_shape key: [B, Hkv, G, hd], prefill [B, C, Hkv, G,
    hd]."""
    return [case.B] + ([case.C] if kern["prefill"] else []) + [
        case.Hkv, case.G, case.hd]


def check_kernels(S: int, seed: int, S_wide: int) -> tuple:
    """Every kernel against its plain version at the main path's shapes,
    the GQA / window variants and phase 12's head shapes (WIDE_HEADS, at
    phase 12's cache length S_wide; WINDOWED_HEADS also with a window).
    Returns (rows for the JSON line, failures, the dense decode kernel's
    split sweep)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    wide_rng = np.random.default_rng(seed + 12)
    static_rng = np.random.default_rng(seed + 14)
    bf16, f32 = torch.bfloat16, torch.float32
    main = dict(B=8, Hkv=16, G=1, S=S, hd=64, page=16, window=0)
    from repro_torch.kernels.decode_attention import ops as dec
    failures, out, sweep = [], [], {}
    table = kernel_table()
    by_name = {k["name"]: k for k in table}
    for kern in table:
        twin = by_name.get(kern.get("twin"))
        chunks = (4, 8, 16, 32) if kern["prefill"] else (None,)
        variants = [("main", dict(main, C=C, dtype=bf16)) for C in chunks]
        variants += [
            ("main-f32", dict(main, C=chunks[-1], dtype=f32)),
            ("gqa-g4", dict(main, Hkv=4, G=4, C=chunks[-1], dtype=f32)),
            ("window-48", dict(main, window=48, C=chunks[-1], dtype=bf16)),
            ("gqa-window-f32", dict(main, Hkv=4, G=4, window=48,
                                    C=chunks[-1], dtype=f32))]
        # phase 12's heads draw from a stream of their own, so that the
        # checks above see the data they always saw
        for hkv, g, hd in WIDE_HEADS:
            wide = dict(main, S=S_wide, Hkv=hkv, G=g, hd=hd, C=chunks[-1],
                        rng=wide_rng)
            variants += [(f"wide-hd{hd}-g{g}", dict(wide, dtype=bf16)),
                         (f"wide-hd{hd}-g{g}-f32", dict(wide, dtype=f32))]
            if (hkv, g, hd) in WINDOWED_HEADS:
                win = dict(wide, window=48)
                variants += [
                    (f"window-hd{hd}-g{g}", dict(win, dtype=bf16)),
                    (f"window-hd{hd}-g{g}-f32", dict(win, dtype=f32))]
        if kern["name"] == "decode_attention":
            for hkv, s_len in STATIC_DECODE:
                variants.append((f"static-hkv{hkv}-s{s_len}", dict(
                    main, B=4, Hkv=hkv, S=s_len, C=None, dtype=bf16,
                    rng=static_rng)))
        err_main, timed, by_shape = 0.0, None, []
        for label, kw in variants:
            kw = dict(kw)
            case = Case(kw.pop("rng", rng), **kw)
            args = _args(kern, case)
            got = kern["fn"](*args, window=case.window)
            again = kern["fn"](*args, window=case.window)
            want = kern["plain"](*_f32(args), window=case.window).float()
            err = float((got - want).abs().max())
            err_bf16 = float((got - kern["plain"](
                *args, window=case.window).float()).abs().max())
            tol = TOL[str(case.dtype).split(".")[1]]
            same = bool(torch.equal(got, again))
            ok = bool(torch.isfinite(got).all()) and err <= tol and same
            tag = f"{kern['name']} {label} C={case.C} {case.dtype}"
            extra = ""
            if not kern["prefill"]:
                n = dec.decode_splits(case.B, case.Hkv, case.G)
                extra = f", n_split {n}"
            if twin is not None:    # same data, dense layout
                same_twin = bool(torch.equal(got, twin["fn"](
                    *_args(twin, case), window=case.window)))
                ok = ok and same_twin
                extra += f", equal to {twin['name']} bit for bit {same_twin}"
            if case.dtype == bf16:
                extra += (f", vs the plain version in bf16 "
                          f"{err_bf16:.3e}")
            print(f"  check {tag}: max_abs_err {err:.3e} (tol {tol:g}), "
                  f"same bits twice {same}{extra} "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                failures.append(tag)
            if label == "main" or label in STATIC_TIMED or (
                    label.startswith("wide") and case.dtype == bf16):
                err_main = max(err_main, err)
                ms = time_case(kern, case)
                twin_note = ""
                if twin is not None:    # the dense twin on the same data
                    tm = time_case(twin, case)
                    ms.update(twin_ms=tm["ms"], twin_library_ms=tm[
                        "library_ms"])
                    twin_note = (f"; dense twin {tm['ms']:.4f} ms "
                                 f"({ms['ms'] / tm['ms']:.2f}x), SDPA on "
                                 f"the dense copy {tm['library_ms']:.4f} ms")
                print(f"  time  {tag}: kernel {ms['ms']:.4f} ms, plain "
                      f"{ms['plain_ms']:.4f} ms, library "
                      f"{ms['library_ms']} ms, bound {ms['bound_ms']:.4f}"
                      f" ms ({ms['bound_by']}){twin_note}", flush=True)
                if label != "main":
                    by_shape.append(dict(shape=_shape_key(kern, case),
                                         launches=None, **ms))
                    continue
                timed, case_main = ms, case   # the largest chunk (32)
                if kern["name"] == "decode_attention":
                    sweep = split_sweep(case)
        by_shape.insert(0, dict(shape=_shape_key(kern, case_main),
                                launches=None, **timed))
        out.append(dict(name=kern["name"], route="cuda",
                        source=kern["source"], replaces=kern["replaces"],
                        launches=None, max_abs_err=err_main, **timed,
                        by_shape=by_shape))
    return out, failures, sweep


SWEEP_SPLITS = (1, 2, 3, 4, 6, 9)


def split_sweep(case) -> dict:
    """Device time of the dense decode kernel at the main case for each
    split count in SWEEP_SPLITS, through its C entry (the wrapper picks
    the count from the shapes); each count's output is held to the
    wrapper's within the bf16 tolerance. {n_split: ms}."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec
    B, H, hd = case.q.shape
    n = max(2, math.ceil(2 * L2_BYTES / case.kv_bytes()))
    copies = [tuple(a.clone() for a in (case.q, case.k, case.v, case.rows))
              for _ in range(n)]
    want = dec.gqa_decode(*copies[0])

    def call(ns):
        def f(q, k, v, rows):
            out = torch.empty((B, H, hd), dtype=torch.float32, device="cuda")
            ws = torch.empty((B, H, ns, hd + 2) if ns > 1 else (0,),
                             dtype=torch.float32, device="cuda")
            st = dec._lib().decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ws.data_ptr(), rows.data_ptr(), B, case.Hkv, case.G, case.S,
                hd, dec.group_rows(case.G), ns, 0, 1.0 / hd ** 0.5, 1,
                torch.cuda.current_stream().cuda_stream)
            if st:
                fail(f"decode_attention n_split {ns}: CUDA error {st}")
            return out
        return f

    res = {}
    for ns in SWEEP_SPLITS:
        err = float((call(ns)(*copies[0]) - want).abs().max())
        if err > TOL["bfloat16"]:
            fail(f"decode_attention n_split {ns} differs by {err}")
        res[ns] = device_ms(call(ns), copies)
    print("  sweep decode_attention main: ms by n_split " + ", ".join(
        f"{ns}: {ms:.4f}" for ns, ms in res.items()), flush=True)
    del copies
    torch.cuda.empty_cache()
    return res


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
    """The fewest integer instructions the packed wire can issue per
    element, a lower count. fmix32's first step, x ^= x >> 16,
    distributes over the XOR with the plane's constant (bit for bit;
    tests/test_torch_kernel_design.py), so its shift is taken once per
    word and each plane starts with one three-input XOR (LOP3) of the
    word, its shift and the plane's folded constant. Per bit plane, 9:
    that XOR, fmix32's two multiplies (IMAD) and two shift-XOR pairs
    (SHF, LOP3), the compare with the threshold and its accumulation
    into the mask. Per element, 3: the word's shift, the mask's XOR
    onto the code and one instruction to form the code. Conversions,
    the float work (a division, rint, a clip, a product) and addressing
    are not counted."""
    return 9 * bits + 3


# Philox4x32-10 per 32-bit word (K6), a lower count: each of the 10
# rounds issues two wide multiplies (IMAD.WIDE, both halves at once) and
# two three-input XORs for 4 words; the key schedule is not counted
PHILOX_INT_OPS_PER_WORD = 10 * (2 + 2) / 4


def wire_inputs(rng, rows: int, bits: int, cols: int = 256):
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
    copies = l2_copies(args)
    res = dict(ms=device_ms(fn, copies), plain_ms=device_ms(plain, copies),
               library_ms=None)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 0.0, torch.float32,
                                                int_ops)
    del copies
    torch.cuda.empty_cache()
    return res


def _by_shape(timed: dict) -> list:
    """A row's per-shape entries: {shape: times} -> [{shape, launches
    (filled in after the main path), times}], in the order timed."""
    return [dict(shape=list(s), launches=None, **t)
            for s, t in timed.items()]


def launch_floor_ms() -> float:
    """Device time per launch of the timing harness itself: one
    one-element in-place add_ per call, in `device_ms`'s CUDA graph. No
    kernel on any path is this small; it is the floor under every
    kernel time the script reports."""
    import torch
    copies = [(torch.zeros(1, device="cuda"),) for _ in range(256)]
    return device_ms(lambda t: t.add_(1.0), copies)


def check_wire_kernels(seed: int) -> tuple:
    """K1, K2, K5 and K6 against their plain versions on the card, bit
    for bit, at the training path's shapes; times at the FL upload's.
    Returns (rows for the JSON line, failures)."""
    import numpy as np
    import torch
    from repro_torch.core.draws import Key
    from repro_torch.kernels import build
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

    # K1 in its three code widths at both shapes, the float32 wire also
    # at Q16 and Q32 (its top level saturates, as XLA's conversion does);
    # the float32 wire at Q8 timed at both
    err1, timed1 = 0.0, {}
    for wire_dtype, bits in (("float32", 8), ("int8", 8), ("int4", 4),
                             ("float32", 16), ("float32", 32)):
        for shape, r in WIRE_SHAPES.items():
            buf, words, scale, p = wire_inputs(rng, r, bits)
            got = qc.packed_wire_2d(buf, words, scale, p, bits,
                                    wire_dtype=wire_dtype)
            want = qref.packed_wire_ref(buf, words, scale, p, bits,
                                        wire_dtype)
            err1 = max(err1, check(f"packed_wire_2d {wire_dtype} Q{bits} "
                                   f"{shape} [{r}, 256]", got, want))
            if wire_dtype == "float32" and bits == 8:
                timed1[(r, 256)] = _timed(
                    lambda *a: qc.packed_wire_2d(*a, 8),
                    lambda *a: qref.packed_wire_ref(*a, 8),
                    (buf, words, scale, p), r * 256 * 12 + r * 8,
                    r * 256 * wire_int_ops(8))
    rows.append(dict(name="packed_wire_2d", route="cuda", source=QC_SRC,
                     replaces=f"{QC}:147", launches=None,
                     max_abs_err=err1,
                     **timed1[(WIRE_SHAPES["fl_upload"], 256)],
                     by_shape=_by_shape(timed1)))

    # K2: 3 users of 360 rows, weights 1/3, at Q32 and (timed) Q8
    n, r = 3, WIRE_SHAPES["fl_upload"] // 3
    w = torch.full((n * r, 1), 1.0 / 3.0, device="cuda")
    err2 = 0.0
    for bits in (32, 8):
        buf, words, scale, p = wire_inputs(rng, n * r, bits)
        got = qc.packed_wire_mean_2d(buf, words, scale, p, w, bits, n)
        want = qref.packed_wire_mean_ref(buf, words, scale, p, w, bits, n)
        err2 = max(err2, check(f"packed_wire_mean_2d Q{bits} 3 users "
                               f"[1080, 256]", got, want))
    rows.append(dict(
        name="packed_wire_mean_2d", route="cuda", source=QC_SRC,
        replaces=f"{QC}:207", launches=None, max_abs_err=err2,
        shape=[n * r, 256],
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
    for bits in (8, 32):
        err5 = max(err5, check(f"quant_channel_2d Q{bits} [256, 512]",
                               qc.quant_channel_2d(x2, w5, p5, bits),
                               qref.quant_channel_ref(x2, w5, p5, bits)))
    row5 = dict(
        name="quant_channel_2d", route="cuda", source=QC_SRC,
        replaces=f"{QC}:244", launches=None, max_abs_err=err5,
        **_timed(lambda *a: qc.quant_channel_2d(*a, 8),
                 lambda *a: qref.quant_channel_ref(*a, 8),
                 (x2, w5, p5), 256 * 512 * 12 + 4,
                 256 * 512 * wire_int_ops(8)))
    row5["geometry"] = dict(zip(("cluster", "rows_per_cta", "threads"),
                                qc.qc_geometry(256, 512, build.sm_count(0))))
    print(f"  K5 at [256, 512]: (CTAs a cluster, rows a CTA, threads) "
          f"{tuple(row5['geometry'].values())}", flush=True)
    rows.append(row5)

    # K6: in-kernel Philox words
    r = WIRE_SHAPES["fl_upload"]
    zero = torch.zeros((r, 256), device="cuda")
    one = torch.ones((r, 1), device="cuda")
    pk = torch.full((r, 1), K6_P, device="cuda")
    b32, _, s32, p32 = wire_inputs(rng, r, 32)
    err6 = check("packed_wire_2d_philox Q32 [1080, 256] vs plain Philox",
                 qc.packed_wire_2d_philox(b32, s32, p32, 32, seed=4321),
                 qref.packed_wire_philox_ref(b32, s32, p32, 32, 4321))
    got = qc.packed_wire_2d_philox(zero, one, pk, 8, seed=1234)
    err6 = max(err6, check("packed_wire_2d_philox Q8 [1080, 256] vs plain "
                           "Philox", got, qref.packed_wire_philox_ref(
                               zero, one, pk, 8, 1234)))
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
    buf, _, scale, p = wire_inputs(rng, r, 8)
    rows.append(dict(
        name="packed_wire_2d_philox", route="cuda", source=QC_SRC,
        replaces=f"{QC}:102", launches=None, max_abs_err=err6,
        **_timed(lambda *a: qc.packed_wire_2d_philox(*a, 8, 99),
                 lambda *a: qref.packed_wire_philox_ref(*a, 8, 99),
                 (buf, scale, p), r * 256 * 8 + r * 8,
                 r * 256 * (wire_int_ops(8) + PHILOX_INT_OPS_PER_WORD))))
    for row in rows:
        for s in row.get("by_shape") or [dict(row, shape="")]:
            print(f"  time  {row['name']} {s['shape']}: kernel "
                  f"{s['ms']:.5f} ms, plain {s['plain_ms']:.4f} ms, bound "
                  f"{s['bound_ms']:.5f} ms ({s['bound_by']})", flush=True)
    return rows, failures


# ------------------------------------------- the tiny model's K3 and K4
CP_SRC = "src/repro_torch/kernels/conv_pool/csrc/conv_pool.cu"
LC_SRC = "src/repro_torch/kernels/lstm_cell/csrc/lstm_cell.cu"
# the JAX suite's tolerance for both kernels (tests/test_kernels.py:124,
# :200), abs and rel: float32 products summed in another order
TINY_TOL = 2e-5
# (B, T, E, K, F): the SL eval slice and a training batch through the
# paper's conv (E 8, K 3, F 32), then ragged batches and an odd T
K3_CASES = [(2048, 30, 8, 3, 32), (512, 30, 8, 3, 32), (1, 30, 8, 3, 32),
            (7, 30, 8, 3, 32), (7, 29, 8, 3, 32)]
# (B, T, E) timed: the eval slice (the row's main numbers) and the
# two-party uplink / capture batch
K3_TIMED = [(2048, 30, 8), (512, 30, 8)]
# (B, T, H): the eval slice and a training batch through the paper's LSTM
# (T 14 pooled positions, H 32), then ragged batches, T 1 and 30, and
# H 8, 16 and 24 (the register body) and 48 (the shared-memory body)
K4_CASES = [(2048, 14, 32), (512, 14, 32), (1, 14, 32), (7, 14, 32),
            (7, 1, 32), (7, 30, 32), (7, 14, 8), (33, 14, 16), (7, 14, 24),
            (7, 14, 48)]
# timed: the eval slice (the row's main numbers) and the uplink batch
K4_TIMED = [(2048, 14, 32), (512, 14, 32)]
# operations per LSTM (row, step, unit) besides the 8H of the recurrent
# dot: 4 adds of xw, 3 sigmoids (negate, exp, add, divide), 2 tanh, and
# the 4 products and sums of the c and h updates
LSTM_GATE_OPS = 4 + 3 * 4 + 2 + 4


def _tiny_close(tag: str, got, want, failures: list) -> float:
    """max |got - want|; a failure unless every element lies within
    TINY_TOL + TINY_TOL * |want| and all are finite."""
    import torch
    d = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and \
        bool((d <= TINY_TOL + TINY_TOL * want.abs()).all())
    err = float(d.max()) if d.numel() else 0.0
    print(f"  check {tag}: max_abs_err {err:.3e} (tol {TINY_TOL:g} abs + "
          f"rel) {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        failures.append(tag)
    return err


def conv_inputs(rng, B: int, T: int, E: int, K: int, F: int) -> tuple:
    """Seeded K3 operands on the card: x [B, T, E] at the embedding's
    scale, w [K, E, F] at the fan-in init's, a small bias [F]."""
    import numpy as np
    import torch
    return tuple(torch.from_numpy((rng.standard_normal(shape) * scale)
                                  .astype(np.float32)).to("cuda")
                 for shape, scale in (((B, T, E), 0.05),
                                      ((K, E, F), 1.0 / math.sqrt(E)),
                                      ((F,), 0.01)))


def lstm_inputs(rng, B: int, T: int, H: int) -> tuple:
    """Seeded K4 operands on the card: gate inputs xw [B, T, 4H] of unit
    scale, Wh [H, 4H] at the fan-in init's."""
    import numpy as np
    import torch
    return tuple(torch.from_numpy((rng.standard_normal(shape) * scale)
                                  .astype(np.float32)).to("cuda")
                 for shape, scale in (((B, T, 4 * H), 1.0),
                                      ((H, 4 * H), 1.0 / math.sqrt(H))))


def qc_inputs(rng, n: int = 89_673, M: int = 256, N: int = 512) -> tuple:
    """Seeded K5 operands on the card as `ops.transmit` pads them: n
    normal values in x [M, N] (zeros after), 32-bit words, p [1]."""
    import numpy as np
    import torch
    from repro_torch.kernels.quant_channel import ops as qc
    x = np.zeros(M * N, np.float32)
    x[:n] = rng.standard_normal(n)
    words = torch.from_numpy(rng.integers(0, 2 ** 32, (M, N),
                                          dtype=np.int64))
    return (torch.from_numpy(x.reshape(M, N)).to("cuda"),
            qc.words_u32(words, "cuda"), torch.tensor([0.02], device="cuda"))


def check_tiny_kernels(seed: int) -> tuple:
    """K3 and K4 against their plain versions on the card at the path's
    shapes and ragged ones, within TINY_TOL; times at the eval slice
    beside the bound, the plain version and the library's calls.
    Returns (rows for the JSON line, summary, failures)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.conv_pool import ref as cref
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.lstm_cell import ref as lref
    rng = np.random.default_rng(seed + 2)
    dev = torch.device("cuda")
    failures, summary = [], {}

    def randn(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    # K3: the eval slice and the uplink batch timed
    err3, timed3 = 0.0, {}
    for B, T, E, K, Fo in K3_CASES:
        x, w, b = conv_inputs(rng, B, T, E, K, Fo)
        got = cp.user_conv_pool(x, w, b)
        tag = f"user_conv_pool [{B}, {T}, {E}] x [{K}, {E}, {Fo}]"
        err3 = max(err3, _tiny_close(tag, got, cref.conv_pool_ref(x, w, b),
                                     failures))
        if not torch.equal(got, cp.user_conv_pool(x, w, b)):
            failures.append(f"{tag}: not the same bits twice")
        if (B, T, E) not in K3_TIMED:
            continue
        t_out, P = T - K + 1, (T - K + 1) // 2
        cps = l2_copies((x, w, b))
        t = dict(ms=device_ms(cp.user_conv_pool, cps),
                 plain_ms=device_ms(cref.conv_pool_ref, cps))
        t["bound_ms"], t["bound_by"] = bound_ms(
            4 * (x.numel() + w.numel() + b.numel() + B * P * Fo),
            B * t_out * Fo * (2 * K * E + 2) + B * P * Fo, torch.float32)
        # the library's nearest: three calls in its own [B, C, T] layout
        # (inputs transposed outside the timing); not one call, so it
        # stands beside the row and not as its library_ms
        wt = w.permute(2, 1, 0).contiguous()
        tri = [(c[0].transpose(1, 2).contiguous(),) for c in cps]

        def triple(xt):
            return F.max_pool1d(torch.relu(F.conv1d(xt, wt, b)), 2)
        t["triple_ms"] = device_ms(triple, tri)
        t["triple_max_abs_err"] = float((triple(tri[0][0]).transpose(1, 2)
                                         - cp.user_conv_pool(*cps[0]))
                                        .abs().max())
        timed3[(B, T, E)] = t
        print(f"  time  user_conv_pool [{B}, {T}, {E}]: kernel "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}); no single PyTorch"
              f" call computes conv + ReLU + pool: conv1d -> relu -> "
              f"max_pool1d (three calls) {t['triple_ms']:.5f} ms (max_abs_err"
              f" {t['triple_max_abs_err']:.2e})", flush=True)
        del cps, tri
    row3 = dict(timed3[K3_TIMED[0]], library_ms=None)
    summary["conv_pool_triple"] = dict(ms=row3.pop("triple_ms"),
                                       max_abs_err=row3.pop(
                                           "triple_max_abs_err"))

    # K4: gate inputs of unit scale, Wh at the fan-in init's; the same
    # bits twice
    err4, timed4 = 0.0, {}
    for B, T, H in K4_CASES:
        xw, wh = lstm_inputs(rng, B, T, H)
        h, c = lc.lstm_final_state(xw, wh)
        hr, cr = lref.lstm_final_state_ref(xw, wh)
        tag = f"lstm_final_state [{B}, {T}, {4 * H}]"
        err4 = max(err4, _tiny_close(tag + " h", h, hr, failures),
                   _tiny_close(tag + " c", c, cr, failures))
        again = lc.lstm_final_state(xw, wh)
        if not (torch.equal(h, again[0]) and torch.equal(c, again[1])):
            failures.append(f"{tag}: not the same bits twice")
        if (B, T, H) not in K4_TIMED:
            continue
        cps = l2_copies((xw, wh))
        geo = lc.lstm_geometry(B, H, build.sm_count(0))
        t = dict(ms=device_ms(lc.lstm_final_state, cps),
                 plain_ms=device_ms(lref.lstm_final_state_ref, cps),
                 geometry=dict(zip(("rows_per_warp", "warps_per_cta",
                                    "grid"), geo)))
        t["bound_ms"], t["bound_by"] = bound_ms(
            4 * (xw.numel() + wh.numel() + 2 * B * H),
            B * T * H * (8 * H + LSTM_GATE_OPS), torch.float32)
        del cps
        # the layer: x @ Wx + b, then the recurrence, against one cuDNN
        # LSTM call (TF32 off) on the same weights
        Fi = 32
        x = randn((B, T, Fi))
        wx = randn((Fi, 4 * H), 1.0 / math.sqrt(Fi))
        bb = randn((4 * H,), 0.1)
        lstm = torch.nn.LSTM(Fi, H, batch_first=True).to(dev).eval()
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(wx.T)
            lstm.weight_hh_l0.copy_(wh.T)
            lstm.bias_ih_l0.copy_(bb)
            lstm.bias_hh_l0.zero_()
        lstm.flatten_parameters()

        def cudnn(x):
            with torch.no_grad():
                return lstm(x)[1][0][0]
        cps = l2_copies((x,))
        t["layer_ms"] = device_ms(lambda x: lc.lstm_layer(x, wx, wh, bb),
                                  cps)
        t["library_ms"] = device_ms(cudnn, cps)
        t["cudnn_max_abs_err"] = float((cudnn(x) - lc.lstm_layer(
            x, wx, wh, bb)).abs().max())
        del cps
        timed4[(B, T, 4 * H)] = t
        print(f"  time  lstm_final_state [{B}, {T}, {4 * H}] (rows a warp, "
              f"warps a CTA, CTAs {geo}): kernel {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}); the layer (x @ Wx + b, then K4) "
              f"{t['layer_ms']:.5f} ms vs one cuDNN nn.LSTM call "
              f"{t['library_ms']:.5f} ms (max_abs_err "
              f"{t['cudnn_max_abs_err']:.2e})", flush=True)
    main4 = timed4[(K4_TIMED[0][0], K4_TIMED[0][1], 4 * K4_TIMED[0][2])]
    row4 = {k: main4[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}
    summary["lstm_layer"] = {str(list(s)): dict(
        ms=t["layer_ms"], cudnn_ms=t["library_ms"],
        cudnn_max_abs_err=t["cudnn_max_abs_err"],
        geometry=t["geometry"])
        for s, t in timed4.items()}
    by_shape4 = [dict(shape=list(s), launches=None,
                      **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")})
                 for s, t in timed4.items()]
    torch.cuda.empty_cache()
    kdir = "src/repro/kernels"
    rows = [dict(name="conv_pool", route="cuda", source=CP_SRC,
                 replaces=f"{kdir}/conv_pool/kernel.py:43", launches=None,
                 max_abs_err=err3, **row3, by_shape=_by_shape(timed3)),
            dict(name="lstm_final_state", route="cuda", source=LC_SRC,
                 replaces=f"{kdir}/lstm_cell/kernel.py:43", launches=None,
                 max_abs_err=err4, **row4, by_shape=by_shape4)]
    return rows, summary, failures


# -------------------------------------------------------- the main path
SERVE_PATH = {"paged": ("paged_decode_attention", "paged_prefill_attention"),
              "dense": ("decode_attention", "prefill_attention")}
# the traced serves (phases 3 and 12) serve the trace's first 2
# requests, each cut to at most 8 new tokens: the profiler's own
# processing of a trace grows with its device events, which grow with
# the decode steps and the layers (on an H100: 8 whole requests of
# qwen1.5-0.5b, 177,590 device events, most of phase 3's 279 s; 4
# requests of stablelm-12b's 40 layers, 62,103 events, 40 s of phase 12)
PROFILED, PROFILED_TOKENS = 2, 8


def traced_sample(trace):
    """The requests a traced serve replays (PROFILED, PROFILED_TOKENS)."""
    import dataclasses
    from repro_torch.serve import RequestTrace
    return RequestTrace(trace.seed, tuple(
        dataclasses.replace(r, max_new_tokens=min(r.max_new_tokens,
                                                  PROFILED_TOKENS))
        for r in trace.requests[:PROFILED]))


def _attention_counters() -> dict:
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.prefill_attention import ops as pre
    return {"decode_attention": dec.gqa_decode,
            "paged_decode_attention": dec.gqa_decode_paged,
            "prefill_attention": pre.gqa_prefill,
            "paged_prefill_attention": pre.gqa_prefill_paged}


def serve_once(cfg, params, trace, kv: str, keep_chunks: bool = False):
    """Serve `trace` with `ServeEngine` on 8 slots, greedy, chunk 32,
    page 16, over a fading 10 dB radio, with K7-K10's launch counters
    set to 0 just before `serve` and read just after. Returns (engine,
    report, first chunks [(chunk tokens, logits)], step calls, launches,
    kept chunks, warmup s). With `keep_chunks`, every prefill call that
    holds a first chunk is kept for a later reference run: the cache as
    it was before the call, the call's inputs, the expert choices of its
    MoE layers (`RouteTape`) and its first-chunk rows."""
    from repro_torch.schemes.radio import Radio
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, n_slots=8, greedy=True, kv=kv,
                      radio=Radio(snr_db=10.0, fading=True), device="cuda")
    warm = eng.warmup_compile(trace.max_seq_len())
    built = eng.build(max(8, trace.max_seq_len()))
    calls = {"decode": 0, "prefill": 0}
    firsts, kept = [], []
    orig = dict(built)
    tape = RouteTape() if keep_chunks and cfg.is_moe else None

    def decode(*a, _f=orig["decode"]):
        calls["decode"] += 1
        return _f(*a)

    def prefill(cache, toks, st, nv, tbl, _f=orig["prefill"]):
        calls["prefill"] += 1
        rows = ((st == 0) & (nv > 0)).nonzero()[:, 0].tolist()
        snap = None
        if keep_chunks and rows:
            snap = {k: v.clone() for k, v in cache.items()}
        with (tape.record() if tape is not None and snap is not None
              else contextlib.nullcontext([])) as routes:
            lg, cache = _f(cache, toks, st, nv, tbl)
        if snap is not None:
            kept.append((snap, toks.clone(), st.clone(), nv.clone(),
                         tbl.clone(), list(routes), rows))
        for b in rows:
            firsts.append((toks[b, :int(nv[b])].clone(), lg[b].clone()))
        return lg, cache

    built.update(decode=decode, prefill=prefill)
    counters = _attention_counters()
    for f in counters.values():
        f.launches = 0
    rep = eng.serve(trace)
    n = {k: f.launches for k, f in counters.items()}
    built.update(orig)
    return eng, rep, firsts, calls, n, kept, warm


def launch_failures(cfg, kv: str, calls: dict, n: dict) -> list:
    """The layout's two kernels once per layer for every decode step and
    prefill chunk, the other two never."""
    kd, kp = SERVE_PATH[kv]
    want = {kd: cfg.n_layers * calls["decode"],
            kp: cfg.n_layers * calls["prefill"]}
    return [f"{cfg.name} kv={kv}: {k} launched {v} times, expected "
            f"{want.get(k, 0)}" for k, v in n.items()
            if v != want.get(k, 0) or (k in want and v == 0)]


def print_serve(tag: str, warm: float, calls: dict, d: dict, n: dict):
    print(f"serve {tag}: warmup {warm:.2f} s; {d['cycles']} cycles "
          f"({calls['decode']} decode steps, {calls['prefill']} "
          f"prefill chunks), {d['generated_tokens']} tokens in "
          f"{d['wall_s']:.3f} s = {d['tokens_per_s']:.1f} tok/s; ttft "
          f"p50/p99 {d['p50_ttft_s']:.4f}/{d['p99_ttft_s']:.4f} s, "
          f"{d['p50_ttft_cycles']:.0f}/{d['p99_ttft_cycles']:.0f} "
          f"cycles; latency p50/p99 {d['p50_latency_cycles']:.0f}/"
          f"{d['p99_latency_cycles']:.0f} cycles; statuses "
          f"{d['statuses']}; launches {n}", flush=True)


def serve_phase(seed: int) -> tuple:
    """Serve qwen1.5-0.5b at full width, paged then dense. Returns
    ({kernel name: launches}, summary dict, failures)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import api as M
    from repro_torch.models import transformer as T
    from repro_torch.nn import count_params, init_params
    from repro_torch.serve import make_trace

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
    failures, launches, runs, prof = [], {}, {}, {}
    for kv in ("paged", "dense"):
        eng, rep, firsts, calls, n, _, warm = serve_once(cfg, params, trace,
                                                         kv)
        d = rep.to_dict()
        print_serve(f"kv={kv}", warm, calls, d, n)
        failures += launch_failures(cfg, kv, calls, n)
        launches.update({k: n[k] for k in SERVE_PATH[kv]})
        runs[kv] = (rep, firsts, d)
        prof[kv] = profile_phase(eng, traced_sample(trace), kv)
        if prof[kv].get("unmatched_kernel_patterns"):
            failures.append(f"kv={kv}: no traced kernel matches "
                            f"{prof[kv]['unmatched_kernel_patterns']}")

    (rp, fp, dp), (rd, fd, dd) = runs["paged"], runs["dense"]
    same_tokens, f = layouts_agree(rp, rd)
    failures += f

    # first-chunk logits: finite, paged == dense, and near forward()
    if len(fp) != len(fd) or not fp:
        failures.append(f"first chunks: {len(fp)} paged, {len(fd)} dense")
    worst_pd, worst_ref, worst_dref, rel = 0.0, 0.0, 0.0, 0.0
    equal_logits = True
    with torch.inference_mode():
        for (tp, lp), (td, ld) in zip(fp, fd):
            if not torch.equal(tp, td):
                failures.append("first chunks differ in tokens")
                break
            equal_logits = equal_logits and bool(torch.equal(lp, ld))
            ref = T.forward(params, {"tokens": tp[None]}, cfg)[0][0, -1]
            ref = ref.float()
            if not (torch.isfinite(lp).all() and lp.shape == ref.shape
                    and torch.isfinite(ld).all()):
                failures.append("first-chunk logits not finite / shape")
            worst_pd = max(worst_pd, float((lp - ld).abs().max()))
            worst_ref = max(worst_ref, float((lp - ref).abs().max()))
            worst_dref = max(worst_dref, float((ld - ref).abs().max()))
            rel = max(rel, float((lp - ref).norm() / ref.norm()))
    print(f"first-chunk logits over {len(fp)} requests: max |paged - "
          f"dense| {worst_pd:.3e} (tol {LOGIT_TOL:g}); max |paged - "
          f"forward| {worst_ref:.3e}, max |dense - forward| "
          f"{worst_dref:.3e} (tol {LOGIT_TOL:g}); max relative L2 (paged) "
          f"{rel:.3e}; paged == dense bit for bit {equal_logits}",
          flush=True)
    if not equal_logits:
        failures.append("paged and dense first-chunk logits are not equal")
    if worst_pd > LOGIT_TOL:
        failures.append(f"paged vs dense logits differ by {worst_pd}")
    if max(worst_ref, worst_dref) > LOGIT_TOL:
        failures.append(f"logits differ from forward() by "
                        f"{max(worst_ref, worst_dref)}")
    ties = divergences(eng, params, cfg, trace, rp, rd)
    if any(abs(t["forward_margin"]) > 2 * LOGIT_TOL for t in ties):
        failures.append("paged and dense greedy tokens part where forward() "
                        "does not put the two choices within 2 LOGIT_TOL")
    summary = {kv: runs[kv][2] for kv in runs}
    summary.update(profile_paged=prof["paged"],
                   profile_dense=prof["dense"],
                   first_chunk_max_abs_paged_dense=worst_pd,
                   first_chunk_max_abs_vs_forward=worst_ref,
                   first_chunk_max_abs_dense_vs_forward=worst_dref,
                   token_divergences=ties,
                   first_chunk_logits_equal=equal_logits,
                   first_chunk_max_rel_l2_vs_forward=rel,
                   equal_token_requests=same_tokens)
    return launches, summary, failures


def layouts_agree(rp, rd) -> tuple:
    """The paged and the dense run bill every request alike and generate
    the same greedy tokens. Returns (requests with equal tokens,
    failures)."""
    def bills(rep):
        return [(r.rid, r.status, r.bits, r.erased_bits, r.energy_j,
                 r.n_tx, r.outage_s, r.uplink_bits, r.downlink_bits)
                for r in rep.results]
    failures = []
    if bills(rp) != bills(rd):
        failures.append("paged and dense bills differ")
    same_tokens = sum(a.tokens == b.tokens
                      for a, b in zip(rp.results, rd.results))
    if same_tokens != len(rp.results) or len(rp.results) != len(rd.results):
        failures.append(f"paged and dense greedy tokens differ in "
                        f"{len(rp.results) - same_tokens} requests")
    print(f"bills equal: {bills(rp) == bills(rd)} ({rp.bits:.0f} bits, "
          f"{rp.energy_j:.6e} J); requests with equal tokens paged vs "
          f"dense: {same_tokens}/{len(rp.results)}", flush=True)
    return same_tokens, failures


def divergences(eng, params, cfg, trace, rp, rd) -> list:
    """Where the paged and the dense run's greedy tokens first part, per
    request: the common context (the delivered prompt, rebuilt from the
    engine's own draws, and the tokens both runs generated) goes through
    the teacher-forced `forward` (plain attention, no kernels), and the
    margin between the two runs' choices in its last logits is returned
    with the top-1 - top-2 gap there. Each run's logits lie within
    LOGIT_TOL of forward(), so a part is a near-tie when that margin is
    within 2 LOGIT_TOL."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import UPLINK, RequestResult
    draws, out = eng.draws(trace.seed), []
    by_rid = {r.rid: r for r in trace.requests}
    with torch.inference_mode():
        for a, b in zip(rp.results, rd.results):
            if a.tokens == b.tokens or a.status != "ok" or b.status != "ok":
                continue
            j = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                     if x != y)
            r = by_rid[a.rid]
            sent = draws.prompt(r.rid, r.prompt_len, cfg.vocab_size)
            radio = dataclasses.replace(eng.radio, snr_db=r.snr_db)
            rx, _ = eng._send_row(radio, draws, r.rid, UPLINK, sent,
                                  cfg.vocab_size, RequestResult(r.rid))
            ctx = torch.tensor(list(rx) + list(a.tokens[:j]),
                               device=eng.device)[None]
            lg = T.forward(params, {"tokens": ctx}, cfg)[0][0, -1].float()
            top = lg.topk(2).values
            out.append(dict(rid=a.rid, token=j, paged=a.tokens[j],
                            dense=b.tokens[j],
                            forward_margin=float(lg[a.tokens[j]]
                                                 - lg[b.tokens[j]]),
                            top2_gap=float(top[0] - top[1])))
    worst = max((abs(t["forward_margin"]) for t in out), default=0.0)
    print(f"paged vs dense greedy tokens part in {len(out)} of "
          f"{len(rp.results)} requests; forward()'s margin between the two "
          f"choices at the first part: max {worst:.4e} (near-tie bound "
          f"{2 * LOGIT_TOL:g})", flush=True)
    for t in out:
        print(f"  request {t['rid']}: token {t['token']}, paged "
              f"{t['paged']} vs dense {t['dense']}, forward margin "
              f"{t['forward_margin']:+.4e}, top-2 gap {t['top2_gap']:.4e}")
    return out


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


def _runs() -> dict:
    """name -> (WirelessConfig, scheme options) of every training run: FL,
    fused SL and CL at phase 5's settings (FL recording the privacy
    capture), the privacy phase's two-party SL, fused SL at Q16 with
    capture, and CL over a 20 dB link with capture (the last two as
    `repro_torch.launch.table2` runs them), and phase 9's FL options."""
    from repro_torch.configs import WirelessConfig
    from repro_torch.launch.table2 import SCHEMES
    sl8 = WirelessConfig(mode="sl", quant_bits=8, snr_db=20.0,
                         compress_factor=4)
    fl = dict(mode="fl", quant_bits=8, snr_db=20.0, n_users=3,
              local_steps=5)
    return {
        "fl": (WirelessConfig(**fl), dict(capture=True)),
        "fl_median": (WirelessConfig(aggregate="median", **fl), {}),
        "fl_dp": (WirelessConfig(**fl), dict(dp_sigma=DP_SIGMA,
                                            dp_clip=DP_CLIP)),
        "fl_dirichlet0.1_fedprox": (WirelessConfig(**fl), dict(
            shards=_dirichlet_shards(), prox_mu=0.1,
            sample_with_replacement=True)),
        "sl": (sl8, {}),
        "cl": (None, {}),
        "sl_two_party": (sl8, dict(protocol="two_party", capture=True)),
        "sl_q16_capture": (SCHEMES["sl_early_cut"][0],
                           dict(SCHEMES["sl_early_cut"][1], capture=True)),
        "cl_20db_capture": (SCHEMES["central"][0], dict(capture=True)),
    }


@functools.lru_cache(maxsize=1)
def _dirichlet_shards():
    """benchmarks/extensions.py's Dirichlet(0.1) shards of the corpus."""
    from repro_torch.data.sentiment import partition_users_dirichlet
    from repro_torch.schemes.base import corpus
    (xtr, ytr), _ = corpus()
    return partition_users_dirichlet(xtr, ytr, 3, alpha=0.1)


class _ShapeLog:
    """Stands in for a kernel wrapper at the site the path calls it
    from, and counts its launches by the shape of the first operand (a
    launch is a call that raised the wrapper's own count). `launches`
    reads and sets the wrapper's count."""

    def __init__(self, fn, counts):
        self.fn, self.counts = fn, counts

    launches = property(lambda s: s.fn.launches,
                        lambda s, n: setattr(s.fn, "launches", n))

    def __call__(self, x, *a, **kw):
        n0 = self.fn.launches
        out = self.fn(x, *a, **kw)
        if self.fn.launches != n0:
            self.counts[tuple(x.shape)] += 1
        return out


@contextlib.contextmanager
def launch_shapes(log: dict):
    """While open, count K1's, K2's, K3's and K4's launches per input
    shape into `log` ({row name: Counter}). The path reaches K1 and K2
    through the ops module (core/wire.py), K3 through
    models/lstm_tiny.py's own import and K4 through `lstm_layer` in its
    ops module, so those four names are swapped for `_ShapeLog`s."""
    from collections import Counter
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.models import lstm_tiny as LT
    sites = [(qc, "packed_wire_2d", "packed_wire_2d"),
             (qc, "packed_wire_mean_2d", "packed_wire_mean_2d"),
             (LT, "user_conv_pool", "conv_pool"),
             (lc, "lstm_final_state", "lstm_final_state")]
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]
    for (mod, attr, row), (_, _, fn) in zip(sites, kept):
        setattr(mod, attr, _ShapeLog(fn, log.setdefault(row, Counter())))
    try:
        yield log
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


def merge_shapes(into: dict, phase: dict, launches: dict,
                 what: str) -> list:
    """Add one phase's launches per shape to `into`. Returns a failure
    for each kernel whose launches per shape do not sum to its
    wrapper's count over the phase (a call site that reaches the
    wrapper by another name than the three that `launch_shapes` swaps)."""
    failures = []
    for row, counts in phase.items():
        if sum(counts.values()) != launches[row]:
            failures.append(f"{what}: {row} launches by shape sum to "
                            f"{sum(counts.values())}, its count is "
                            f"{launches[row]}")
        into.setdefault(row, type(counts)()).update(counts)
    return failures


def _tiny_counts() -> tuple:
    """The launch counters of K1, K3 and K4."""
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.quant_channel import ops as qc
    return (qc.packed_wire_2d.launches, cp.user_conv_pool.launches,
            lc.lstm_final_state.launches)


def two_party_scores(sess) -> tuple:
    """(accuracy, loss) of a two-party session on the test set, through
    `SLSession.predict` on the eval keys (the scheme's convention)."""
    import numpy as np
    import torch
    from repro_torch.core.draws import Key
    from repro_torch.models import lstm_tiny as LT
    from repro_torch.schemes.base import corpus
    from repro_torch.schemes.split import EVAL_KEY
    xte, yte = corpus()[1]
    dev = sess.user_params["embed"].device
    accs, losses = [], []
    for i in range(0, max(len(xte) - 2048 + 1, 1), 2048):
        logits = sess.predict(torch.from_numpy(xte[i:i + 2048]).to(dev),
                              Key(EVAL_KEY + i))
        y = torch.from_numpy(yte[i:i + 2048]).to(dev)
        accs.append(float(LT.accuracy(logits, y)))
        losses.append(float(LT.bce_loss(logits, y)))
    return float(np.mean(accs)), float(np.mean(losses))


def _train_run(name: str, cycles: int, device: str, seed: int) -> dict:
    """One scheme of `_runs()` through `Experiment` at the paper's full
    size; counts K1, K3 and K4 launches inside each round and inside each
    eval apart, times each cycle (round + eval) on the host clock, and
    scores the model's test-set loss after each cycle (CL, FL, two-party
    SL). FL keeps each cycle's upload (draw path, sent weights, delivered
    weights, on the host) and synced model."""
    import torch
    from repro_torch.nn import tree_map
    from repro_torch.schemes import Experiment, build_scheme
    from repro_torch.schemes.base import corpus, evaluate
    wcfg, opts = _runs()[name]
    mode = "cl" if wcfg is None else wcfg.mode
    scheme = build_scheme(wcfg, device=device, **opts)
    rounds, evals, walls = [], [], []
    orig_round, orig_eval = scheme.round, scheme.evaluate

    def counted(fn, out):
        def run(*a):
            n0 = _tiny_counts()
            r = fn(*a)
            if device == "cuda":
                torch.cuda.synchronize()
            out.append(tuple(b - a for a, b in zip(n0, _tiny_counts())))
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
        if name == "sl_two_party":
            test_losses.append(two_party_scores(exp.final_state.train)[1])
        elif mode != "sl":        # fused SL's deployed function: apart
            params = exp.final_state.train.trainable["model"]
            if mode == "fl":
                params = tree_map(lambda p: p[0], params)
                synced.append(host(params))
            test_losses.append(evaluate(params, *corpus()[1])[1])
        t[0] = time.perf_counter()

    exp = Experiment(scheme, cycles=cycles, seed=seed, on_cycle=on_cycle)
    res = exp.run()
    return dict(mode=mode, name=name, device=device, wcfg=wcfg, exp=exp,
                res=res, round_launches=[r[0] for r in rounds],
                eval_launches=[e[0] for e in evals],
                round_k34=[r[1:] for r in rounds],
                eval_k34=[e[1:] for e in evals], walls=walls,
                test_losses=test_losses, uploads=uploads, synced=synced)


def sync_check(run) -> dict:
    """The card run's first FL sync redone on the CPU (plain versions)
    from the weights the card uploaded, under the same draws: whether
    the delivered weights and their aggregate (FedAvg, or the median)
    equal the card's bit for bit,
    and how far the synced model's CPU score lies from the card's."""
    import torch
    from repro_torch.core import federated as FED
    from repro_torch.core.draws import Key
    from repro_torch.nn import tree_leaves, tree_map
    from repro_torch.schemes.base import corpus, evaluate
    from repro_torch.schemes.radio import Radio
    path, sent, got = run["uploads"][0]
    dlv = Radio.from_wcfg(run["wcfg"]).send_stacked(Key(*path).draws(), sent)
    avg = tree_map(FED.aggregator(run["wcfg"].aggregate), dlv.payload)
    acc, loss = evaluate(avg, *corpus()[1])
    return dict(
        delivered_equal=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(dlv.payload), tree_leaves(got))),
        synced_equal=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(avg), tree_leaves(run["synced"][0]))),
        abs_d_accuracy=abs(acc - run["res"].accuracy[0]),
        abs_d_test_loss=(abs(loss - run["test_losses"][0])
                         if run.get("test_losses") else None))


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


def train_phase(seed: int, shapes: dict) -> tuple:
    """FL 2 cycles, SL 1, CL 1 on the card (the main path: counters set to
    0 before, read after; K1's, K3's and K4's launches by shape added to
    `shapes`), the same runs for one cycle on the CPU, and one traced FL
    cycle. Returns ({kernel name: launches}, summary, failures, the
    card's runs by mode)."""
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.schemes.base import BATCH, N_TRAIN
    counters = dict(_wire_counters(), conv_pool=cp.user_conv_pool,
                    lstm_final_state=lc.lstm_final_state)
    for f in counters.values():
        f.launches = 0
    with launch_shapes({}) as phase_shapes:
        card = {m: _train_run(m, c, "cuda", seed)
                for m, c in (("fl", 2), ("sl", 1), ("cl", 1))}
    launches = {k: f.launches for k, f in counters.items()}
    failures = merge_shapes(shapes, phase_shapes, launches, "training")
    summary = {}
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
              f"{run['eval_launches']}; (K3, K4) per round "
              f"{run['round_k34']}, per eval {run['eval_k34']}", flush=True)
        summary[m] = dict(wall_per_cycle_s=run["walls"],
                          accuracy=res.accuracy, loss=res.loss,
                          bits=[r.bits for r in exp.reports],
                          steps=[r.steps for r in exp.reports],
                          k1_round_launches=run["round_launches"],
                          k1_eval_launches=run["eval_launches"],
                          k34_round_launches=run["round_k34"],
                          k34_eval_launches=run["eval_k34"])
        # each eval is one slice of 2,048 rows: K3 and K4 once each, and
        # never inside a training round (autograd runs the plain ops)
        if any(k != (0, 0) for k in run["round_k34"]) or \
                any(k != (1, 1) for k in run["eval_k34"]):
            failures.append(f"{m}: (K3, K4) launches per round "
                            f"{run['round_k34']}, per eval {run['eval_k34']}")
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
    return launches, summary, failures, card


# ------------------------------------- two-party SL and the privacy study
# the SL adversary trained on the card against the same adversary (same
# observations, initial weights and batch rows) trained on the CPU:
# relative gap of the held-out errors
RECON_REL_TOL = 0.05


def privacy_phase(seed: int, fl_run: dict, card_name: str,
                  shapes: dict) -> tuple:
    """The slice's main path, with every counter set to 0 before and read
    after (K1's, K3's and K4's launches by shape added to `shapes`):
    two-party SL (Q8, 20 dB), fused SL at Q16 with capture and CL over a
    20 dB link with capture, one cycle each on the card. Then
    two-party SL on the CPU on the same draws, and the Table II rows from
    the captures (FL's from phase 5's card run). Returns ({kernel name:
    launches}, summary, failures)."""
    from repro_torch.core import privacy as PRIV
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.launch import table2 as T2
    from repro_torch.schemes.base import BATCH, N_TRAIN
    ADV_STEPS = T2.ADV_STEPS
    counters = dict(_wire_counters(), conv_pool=cp.user_conv_pool,
                    lstm_final_state=lc.lstm_final_state)
    for f in counters.values():
        f.launches = 0
    with launch_shapes({}) as phase_shapes:
        card = {n: _train_run(n, 1, "cuda", seed) for n in
                ("sl_two_party", "sl_q16_capture", "cl_20db_capture")}
    launches = {k: f.launches for k, f in counters.items()}
    failures = merge_shapes(shapes, phase_shapes, launches, "privacy")
    summary = {}
    steps = N_TRAIN // BATCH
    n_cap = -(-steps // 8)              # capture_every 8
    # (K1, K3, K4) per round and per eval, and the steps of the round
    want = {"sl_two_party": ((2 * steps, steps, 0), (1, 1, 1)),
            "sl_q16_capture": ((2 * steps + n_cap, n_cap, 0), (1, 1, 1)),
            "cl_20db_capture": ((0, 0, 0), (0, 1, 1))}
    for n, run in card.items():
        res, exp = run["res"], run["exp"]
        got = ((run["round_launches"][0],) + run["round_k34"][0],
               (run["eval_launches"][0],) + run["eval_k34"][0])
        print(f"privacy {n} on the card: wall {run['walls'][0]:.3f} s; "
              f"accuracy {res.accuracy[0]:.4f}; loss {res.loss[0]:.4f}; "
              f"bits {exp.reports[0].bits} (init "
              f"{exp.init_delivery.bits if exp.init_delivery else 0.0}); "
              f"(K1, K3, K4) launches per round {got[0]}, per eval {got[1]}"
              f" (want {want[n]})", flush=True)
        summary[n] = dict(wall_s=run["walls"][0], accuracy=res.accuracy[0],
                          loss=res.loss[0], bits=exp.reports[0].bits,
                          launches_round=got[0], launches_eval=got[1])
        if got != want[n] or exp.reports[0].steps != steps:
            failures.append(f"{n}: (K1, K3, K4) launches {got}, want "
                            f"{want[n]}, over {exp.reports[0].steps} steps")
        if not (math.isfinite(res.accuracy[0]) and
                math.isfinite(res.loss[0])):
            failures.append(f"{n}: non-finite accuracy or loss")
    if not (launches["conv_pool"] and launches["lstm_final_state"]):
        failures.append(f"K3/K4 not launched on the path: {launches}")

    # two-party SL on the CPU, the same draws: equal bills, close training
    tp, th = card["sl_two_party"], _train_run("sl_two_party", 1, "cpu",
                                              seed)
    bills = [[(r.bits, r.n_tx, r.erased_bits, r.energy_j)
              for r in run["exp"].reports] for run in (tp, th)]
    da = abs(tp["res"].accuracy[0] - th["res"].accuracy[0])
    dl = abs(tp["res"].loss[0] - th["res"].loss[0])
    dt = abs(tp["test_losses"][0] - th["test_losses"][0])
    print(f"privacy sl_two_party card vs CPU: bills equal "
          f"{bills[0] == bills[1]} ({bills[0]}); |d train loss| {dl:.2e} "
          f"(tol {LOSS_TOL}), |d accuracy| {da:.5f} (tol {ACC_TOL}), |d "
          f"test loss| {dt:.2e} (tol {TEST_LOSS_TOL}); CPU wall "
          f"{th['walls'][0]:.2f} s", flush=True)
    summary["sl_two_party"].update(
        cpu_bills_equal=bills[0] == bills[1], cpu_abs_d_loss=dl,
        cpu_abs_d_accuracy=da, cpu_abs_d_test_loss=dt,
        cpu_wall_s=th["walls"][0])
    if bills[0] != bills[1]:
        failures.append("two-party SL: card and CPU bills differ")
    if dl > LOSS_TOL or da > ACC_TOL or dt > TEST_LOSS_TOL:
        failures.append(f"two-party SL card vs CPU: loss {dl}, accuracy "
                        f"{da}, test loss {dt}")

    # the captures' shapes and counts
    caps = {n: card[n]["res"].captures for n in card}
    caps["fl"] = fl_run["res"].captures
    n_sync = len(fl_run["exp"].reports)
    shapes = {
        "cl_20db_capture": [(k, [caps["cl_20db_capture"][k].shape],
                             [(N_TRAIN, 30)]) for k in ("received",
                                                        "original")],
        "fl": [("deltas", [d.shape for d in caps["fl"]["deltas"]],
                [(3, 89_673)] * n_sync),
               ("targets", [t.shape for t in caps["fl"]["targets"]],
                [(3, 30)] * n_sync)],
        "sl_q16_capture": [("smashed", [z.shape for z in
                                        caps["sl_q16_capture"]["smashed"]],
                            [(BATCH, 14, 8)] * n_cap),
                           ("original", [o.shape for o in
                                         caps["sl_q16_capture"]["original"]],
                            [(BATCH, 30)] * n_cap)],
        "sl_two_party": [("smashed", [z.shape for z in
                                      caps["sl_two_party"]["smashed"]],
                          [(BATCH, 14, 8)] * n_cap),
                         ("original", [o.shape for o in
                                       caps["sl_two_party"]["original"]],
                          [(BATCH, 30)] * n_cap)]}
    for n, items in shapes.items():
        for k, got, want_s in items:
            ok = [tuple(g) for g in got] == want_s
            print(f"privacy capture {n} {k}: {len(got)} x "
                  f"{tuple(got[0]) if got else None} "
                  f"{'ok' if ok else 'FAILED (want %s)' % want_s[:1]}",
                  flush=True)
            if not ok:
                failures.append(f"capture {n} {k} shapes {got}")

    # Table II from the captures, through the entry point's own assembly
    # (repro_torch.launch.table2, benchmarks/table2.py's order)
    draws = PRIV.AdversaryDraws(seed + T2.ADV_SEED)
    t0 = time.perf_counter()
    rows = T2.rows_from_runs(card["cl_20db_capture"]["res"], fl_run["res"],
                             card["sl_q16_capture"]["res"], draws,
                             adv_steps=ADV_STEPS)
    t_adv = time.perf_counter() - t0
    err_sl = rows["sl_early_cut"]["recon_error"]
    sl_obs = T2.sl_pair(caps["sl_q16_capture"])
    t0 = time.perf_counter()
    err_sl_cpu = PRIV.reconstruction_error(draws, *sl_obs, steps=ADV_STEPS,
                                           device="cpu")
    t_cpu = time.perf_counter() - t0
    rel = abs(err_sl - err_sl_cpu) / err_sl_cpu
    print(f"privacy SL adversary ({ADV_STEPS} steps on {len(sl_obs[0])} "
          f"observations): card {err_sl:.6g}, CPU {err_sl_cpu:.6g}, "
          f"relative gap {rel:.3e} (tol {RECON_REL_TOL}); the four "
          f"adversaries on the card {t_adv:.2f} s (FL projection and "
          f"direct read included), on the CPU {t_cpu:.2f} s", flush=True)
    summary["sl_adversary"] = dict(card=err_sl, cpu=err_sl_cpu,
                                   rel_gap=rel, card_s=t_adv, cpu_s=t_cpu)
    if not rel <= RECON_REL_TOL:
        failures.append(f"SL reconstruction error card {err_sl} vs CPU "
                        f"{err_sl_cpu}")
    if not err_sl > rows["central"]["recon_error"]:
        failures.append(f"privacy: err_SL {err_sl} <= err_CL "
                        f"{rows['central']['recon_error']}")
    # the port's two-party SL row, scored as Table II's SL row
    tp_err = PRIV.reconstruction_error(
        draws, *T2.sl_pair(caps["sl_two_party"]), steps=ADV_STEPS)
    tp_row = T2.energy_row(tp["res"], _runs()["sl_two_party"][0], tp_err)
    cycles = dict(central=len(card["cl_20db_capture"]["res"].accuracy),
                  fl_q8=len(fl_run["res"].accuracy),
                  sl_early_cut=len(card["sl_q16_capture"]["res"].accuracy),
                  sl_two_party_q8=len(tp["res"].accuracy))
    print(f"table2 rows ({card_name}; cycles {cycles}; the entry point's "
          f"lines):", flush=True)
    for line in T2.lines(rows):
        print(line, flush=True)
    for k, v in tp_row.items():
        print(f"table2,sl_two_party_q8,{k},{v:.6g}", flush=True)
    # the held-out error of an adversary that answers the mean token
    guess = T2.mean_guess_error(sl_obs[1])
    ratios = T2.ratios(rows)
    print(f"table2 orderings (printed, not gated; the paper's 20 / 7 / 35 "
          f"cycles give SL ~4x FL ~18x CL): err_SL / err_FL "
          f"{ratios['sl_over_fl']:.3f}, err_SL / err_CL "
          f"{ratios['sl_over_cl']:.3f}, err_FL / err_CL "
          f"{ratios['fl_over_cl']:.3f}; answering the training rows' mean "
          f"token scores {guess:.6g} on SL's held-out targets", flush=True)
    summary["table2"] = dict(rows=dict(rows, sl_two_party_q8=tp_row),
                             cycles=cycles, claims=dict(T2.claims(rows)),
                             ratios=ratios, mean_guess_error=guess)
    return launches, summary, failures


# ------------------------------------------------ phase 7b: Fig. 3
FIG3_N_TRAIN, FIG3_N_TEST = 3072, 512
# the Fig. 3 scripts' line names at one cycle a run (3c's four SNRs below
# 10 cycles): benchmarks/accuracy_cycles.py:42-47, quant_sweep.py:36-41,
# snr_sweep.py:53-62, fading.py:46-54
FIG3_SERIES = {"a": ("cl", "fl_q8", "fl_q32", "sl"),
               "b": ("q4", "q8", "q16", "q32"),
               "d": ("cl_clean", "cl_fading", "fl_q8_fading", "sl_fading")}
FIG3_CLAIMS = {"a": ("parity_gap_max,claim<0.02",),
               "b": ("q4_below_q8,claim", "q8_matches_q32,claim"),
               "d": ("cl_degradation,claim>=0", "fl_robust,gap_to_clean",
                     "sl_robust,gap_to_clean")}
FIG3_SNR_SERIES, FIG3_SNRS = ("cl", "fl", "fl_arq", "sl"), (0, 10, 20, 30)


def fig3_line_names() -> list:
    """The `fig3a,...` to `fig3d,...` lines' names (all but the value)."""
    out = []
    for p in "abcd":
        if p == "c":
            out += [f"fig3c,{m},snr{snr}dB" for m in FIG3_SNR_SERIES
                    for snr in FIG3_SNRS]
            out += [f"fig3c,{m},plateau_20db_gap" for m in FIG3_SNR_SERIES]
        else:
            out += [f"fig3{p},{k},final_acc" for k in FIG3_SERIES[p]]
            out += [f"fig3{p},{c}" for c in FIG3_CLAIMS[p]]
    return out


def fig3_phase(seed: int, card_name: str, shapes: dict) -> tuple:
    """Phase 7b: Fig. 3's panels through `repro_torch.launch.fig3` on
    the card, one cycle a run at FIG3_N_TRAIN / FIG3_N_TEST rows, every
    counter set to 0 before and read after (K1's, K3's and K4's launches
    by shape added to `shapes`); the entry point's own checks
    (`fig3.failures`: bills, launches, finite scores), JAX's line names,
    and FL Q32 rerun on the CPU. Returns ({kernel name: launches},
    summary, failures)."""
    import torch
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.launch import fig3 as F3
    from repro_torch.launch import table2 as T2
    counters = dict(_wire_counters(), conv_pool=cp.user_conv_pool,
                    lstm_final_state=lc.lstm_final_state)
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    with launch_shapes({}) as phase_shapes:
        f3 = F3.run(F3.PANELS, seed=seed, cycles=1, fl_cycles=1,
                    sl_cycles=1, n_train=FIG3_N_TRAIN, n_test=FIG3_N_TEST,
                    device="cuda")
    card_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    failures = merge_shapes(shapes, phase_shapes, launches, "fig3")
    failures += [f"fig3: {m}" for m in F3.failures(f3, "cuda")]
    runs = F3.summary(f3, "cuda")
    for p, specs in f3.specs.items():
        for sp, r in zip(specs, runs[p]):
            print(f"fig3 {sp.name} on the card: wall {r['s_per_cycle'][0]:.3f}"
                  f" s (init {r['init_s']:.3f}); accuracy "
                  f"{r['accuracy'][0]:.4f}; loss {r['loss'][0]:.4f}; bits "
                  f"{r['bits'][0]:.0f} (init {r['init_bits']:.0f}; closed "
                  f"form {r['want_bits'][0]:.0f}, init "
                  f"{r['want_init_bits']:.0f}); n_tx {r['n_tx'][0]:g}; "
                  f"(K1, K3, K4) per round {r['launches_round'][0]}, per "
                  f"eval {r['launches_eval'][0]} (path "
                  f"{r['want_launches']})", flush=True)
    lines = [ln for p in F3.PANELS for ln in F3.lines(p, f3.results[p])]
    print(f"fig3 lines ({card_name}; one cycle a run, {FIG3_N_TRAIN} / "
          f"{FIG3_N_TEST} rows):", flush=True)
    for ln in lines:
        print(ln, flush=True)
    names = [ln.rsplit(",", 1)[0] for ln in lines]
    if names != fig3_line_names():
        failures.append(f"fig3 line names {names} are not the JAX "
                        f"scripts' {fig3_line_names()}")
    # FL Q32 (3a) once more on the CPU, the same draws
    i = [sp.series for sp in f3.specs["a"]].index("fl_q32")
    sp, card = f3.specs["a"][i], f3.runs["a"][i]
    t0 = time.perf_counter()
    cpu = T2.drive(sp.wcfg, sp.cycles, sp.seed, sp.n_train, sp.n_test,
                   torch.device("cpu"), **sp.options())
    cpu_s = time.perf_counter() - t0
    bills = [[(r.bits, r.n_tx, r.erased_bits, r.energy_j)
              for r in run.reports] for run in (card, cpu)]
    da = abs(card.result.accuracy[0] - cpu.result.accuracy[0])
    dl = abs(card.result.loss[0] - cpu.result.loss[0])
    print(f"fig3 FL Q32 card vs CPU: bills equal {bills[0] == bills[1]} "
          f"({bills[0]}); |d accuracy| {da:.5f} (tol {ACC_TOL}), |d train "
          f"loss| {dl:.2e} (tol {LOSS_TOL}); card phase {card_s:.1f} s, "
          f"CPU run {cpu_s:.1f} s", flush=True)
    if bills[0] != bills[1]:
        failures.append("fig3 FL Q32: card and CPU bills differ")
    if da > ACC_TOL or dl > LOSS_TOL:
        failures.append(f"fig3 FL Q32 card vs CPU: accuracy {da}, loss {dl}")
    if not all(launches[k] for k in ("packed_wire_2d", "conv_pool",
                                     "lstm_final_state")):
        failures.append(f"fig3: K1 / K3 / K4 not all launched: {launches}")
    summary = dict(runs=runs, results=f3.results, lines=lines,
                   card_s=card_s, fl_q32_cpu=dict(
                       bills_equal=bills[0] == bills[1], abs_d_accuracy=da,
                       abs_d_loss=dl, cpu_s=cpu_s))
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
    """One FL cycle (the paper's full size) under torch.profiler, device
    activity only (its ~180,000 kernels; host op events would multiply
    the trace's processing time): the share of the traced wall time in
    which no kernel ran on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import WirelessConfig
    from repro_torch.schemes import Experiment, build_scheme
    scheme = build_scheme(WirelessConfig(mode="fl", quant_bits=8),
                          device="cuda")
    exp = Experiment(scheme, cycles=1, seed=seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _idle_summary(prof, wall_us, "FL cycle")


# device kernels of each serving attention path: a traced kernel counts
# for an entry when its name holds every part of one of the entry's
# patterns. K7 / K8 are the split pass (templated on the column mapper)
# and its merge, K9 / K10 the tensor-core prefill (f32 prefill is not on
# the serving path). A pattern that matches no traced kernel fails the run
ATTENTION_KERNELS = {
    "dense": {"decode_attention": (("split_decode_kernel", "DenseCols"),
                                   ("merge_splits_kernel",)),
              "prefill_attention": (("prefill_mma_kernel", "DenseCols"),)},
    "paged": {"paged_decode_attention": (("split_decode_kernel",
                                          "PagedCols"),
                                         ("merge_splits_kernel",)),
              "paged_prefill_attention": (("prefill_mma_kernel",
                                           "PagedCols"),)}}


def profile_phase(eng, trace, kv: str, kernels=None) -> dict:
    """One serve of `trace` under torch.profiler, after the timed runs
    (tracing slows the host, so the end-to-end numbers come from the
    untraced runs): the share of the traced wall time in which a kernel
    ran on the card, device time by kernel, host time by op, and each
    attention kernel's share of the device's busy time (`kernels`, by
    default ATTENTION_KERNELS[kv]). Patterns that match no traced kernel
    are listed under "unmatched_kernel_patterns"."""
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
                        f"{kv} serve, {len(trace.requests)} requests")
    out["cycles"] = rep.cycles
    kernels = ATTENTION_KERNELS[kv] if kernels is None else kernels
    if "device_us_by_kernel" in out:
        busy_us = out["device_busy_s"] * 1e6
        names = out["device_us_by_kernel"]
        out["unmatched_kernel_patterns"] = [
            pat for pats in kernels.values() for pat in pats
            if not any(all(p in k for p in pat) for k in names)]
        for name, pats in kernels.items():
            us = sum(t for k, (n, t) in names.items()
                     if any(all(p in k for p in pat) for pat in pats))
            out[f"{name}_share_of_busy"] = us / busy_us
            print(f"  {name}: {us / 1e3:.3f} ms of the device's busy "
                  f"{busy_us / 1e3:.3f} ms = {us / busy_us:.4f}", flush=True)
    return out


def _idle_summary(prof, wall_us: float, label: str) -> dict:
    """Device busy time (union of kernel spans), idle share of the traced
    wall time, device time by kernel and by op (self), and host self
    time by op."""
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
    averages = prof.key_averages()
    top_host = sorted(averages, key=lambda a: -a.self_cpu_time_total)[:12]
    out = {"traced_wall_s": wall_us / 1e6,
           "device_busy_s": busy / 1e6,
           "device_idle_share": 1.0 - busy / wall_us,
           "device_kernels": len(kern),
           "device_us_by_kernel": by_kernel,
           "device_us_by_op": {a.key: a.self_device_time_total
                               for a in averages
                               if a.self_device_time_total > 0},
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


# ------------------------------------------- the tiny model as a server
# phase 8: the paper's classifier served by ServeEngine on the card.
# Each served request's class logit after its 30 prompt tokens (the
# streaming decode: plain ops, no kernel) against `lstm_tiny.forward` on
# the same tokens (K3 + K4 on the card) within TINY_TOL abs + rel; the
# same trace on the CPU (plain ops, the same draws) gives the same bills
# exactly, and the same tokens and TTFT cycles except where the class
# logit lies within 2 TINY_TOL of 0 (a near-tie, listed)
TINY_REQUESTS, TINY_SLOTS = 256, 32
TINY_PROMPT = 30                 # the corpus' padded tweet length


def tiny_trace(seed: int):
    """256 requests of 30-token prompts: one new token (the class) each,
    four for every fourth so that generated tokens are fed back; eight
    arrive per cycle; every user over a 10 dB link."""
    from repro_torch.serve import Request, RequestTrace
    return RequestTrace(seed, tuple(
        Request(rid=i, arrival_cycle=i // 8, prompt_len=TINY_PROMPT,
                max_new_tokens=4 if i % 4 == 3 else 1, snr_db=10.0)
        for i in range(TINY_REQUESTS)))


def tiny_engine(params, device: str):
    from repro_torch.configs import get_arch
    from repro_torch.schemes.radio import Radio
    from repro_torch.serve import ServeEngine
    return ServeEngine(get_arch("paper-tinylstm"), params,
                       n_slots=TINY_SLOTS, greedy=True, kv="paged",
                       radio=Radio(snr_db=10.0, fading=True), device=device)


def tiny_context_z(eng, trace, rid: int, generated) -> float:
    """The class logit `forward` (plain ops, on the CPU) gives after the
    request's delivered prompt (rebuilt from the engine's draws) and
    `generated`: the decode step's logit there, up to TINY_TOL."""
    import dataclasses
    import torch
    from repro_torch.models import lstm_tiny as LT
    from repro_torch.nn import tree_map
    from repro_torch.serve.engine import UPLINK, RequestResult
    r = {q.rid: q for q in trace.requests}[rid]
    draws = eng.draws(trace.seed)
    sent = draws.prompt(rid, r.prompt_len, eng.cfg.vocab_size)
    radio = dataclasses.replace(eng.radio, snr_db=r.snr_db)
    rx, _ = eng._send_row(radio, draws, rid, UPLINK, sent,
                          eng.cfg.vocab_size, RequestResult(rid))
    ctx = torch.tensor(list(rx) + list(generated))[None]
    params = tree_map(lambda a: a.detach().cpu(), eng.params)
    with torch.inference_mode():
        return float(LT.forward(params, {"tokens": ctx})[0][0, 0])


def tiny_serve_phase(seed: int, params: dict, shapes: dict) -> tuple:
    """Serve the tiny model on the card with phase 5's CL-trained
    weights, the K1/K3/K4 and attention counters set to 0 before and
    read after; the checks above; one traced serve of 64 requests for
    the idle share. Returns ({kernel name: launches}, summary,
    failures)."""
    import torch
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.prefill_attention import ops as pre
    from repro_torch.models import lstm_tiny as LT
    from repro_torch.nn import tree_map
    from repro_torch.serve import RequestTrace
    failures = []
    trace = tiny_trace(seed)
    eng = tiny_engine(params, "cuda")
    if eng.kv != "dense":
        failures.append(f"tiny engine kv {eng.kv!r}, not dense")
    warm = eng.warmup_compile(trace.max_seq_len())
    built = eng.build(max(8, trace.max_seq_len()))
    firsts, orig = [], built["prefill"]

    def prefill(cache, toks, st, nv, tbl):
        lg, cache = orig(cache, toks, st, nv, tbl)
        for b in ((st == 0) & (nv == TINY_PROMPT)).nonzero()[:, 0].tolist():
            firsts.append((toks[b, :TINY_PROMPT].clone(), lg[b].clone()))
        return lg, cache

    built["prefill"] = prefill
    attn = {"decode_attention": dec.gqa_decode,
            "paged_decode_attention": dec.gqa_decode_paged,
            "prefill_attention": pre.gqa_prefill,
            "paged_prefill_attention": pre.gqa_prefill_paged}
    counters = dict(_wire_counters(), conv_pool=cp.user_conv_pool,
                    lstm_final_state=lc.lstm_final_state, **attn)
    for f in counters.values():
        f.launches = 0
    with launch_shapes({}) as phase_shapes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.serve(trace)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        built["prefill"] = orig
        serve_launches = {k: f.launches for k, f in counters.items()}
        # each served request's first class logit against forward()
        toks = torch.stack([t for t, _ in firsts])
        with torch.inference_mode():
            ref = LT.forward(eng.params, {"tokens": toks})[0][:, 0]
        torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    failures += merge_shapes(shapes, phase_shapes, launches, "tiny serving")
    got = torch.stack([lg[1] for _, lg in firsts])
    err = (got - ref).abs()
    worst = float((err / (TINY_TOL + TINY_TOL * ref.abs())).max())
    served = sum(r.status != "uplink_erased" for r in rep.results)
    d = rep.to_dict()
    print(f"tiny serve on the card: warmup {warm:.2f} s; {TINY_REQUESTS} "
          f"requests, {d['cycles']} cycles, {d['generated_tokens']} tokens "
          f"in {serve_s:.3f} s = {TINY_REQUESTS / serve_s:.1f} requests/s; "
          f"ttft p50/p99 {d['p50_ttft_s']:.4f}/{d['p99_ttft_s']:.4f} s, "
          f"{d['p50_ttft_cycles']:.0f}/{d['p99_ttft_cycles']:.0f} cycles; "
          f"statuses {d['statuses']}; kv {eng.kv}; launches in the serve "
          f"{serve_launches}", flush=True)
    print(f"tiny serve: {len(firsts)} first class logits vs forward() (K3 "
          f"{launches['conv_pool']}, K4 {launches['lstm_final_state']} "
          f"launches): max |d| {float(err.max()):.3e}, max |d| / (tol + "
          f"tol |z|) {worst:.3f} (tol {TINY_TOL}); finite "
          f"{bool(torch.isfinite(got).all())}; |z| min "
          f"{float(ref.abs().min()):.3e}, mean {float(ref.abs().mean()):.3f}",
          flush=True)
    if any(serve_launches[k] for k in attn):
        failures.append(f"tiny serving launched attention kernels "
                        f"{serve_launches}")
    if serve_launches["conv_pool"] or serve_launches["lstm_final_state"]:
        failures.append("the tiny decode step launched K3 / K4")
    if not (launches["conv_pool"] and launches["lstm_final_state"]):
        failures.append("forward() on the card did not launch K3 and K4")
    if len(firsts) != served or not served:
        failures.append(f"{len(firsts)} first chunks for {served} served "
                        f"requests")
    if not (worst <= 1.0 and bool(torch.isfinite(got).all())):
        failures.append(f"tiny class logits off forward(): {worst}")

    # the same trace on the CPU, the same draws
    cpu = tiny_engine(tree_map(lambda a: a.detach().cpu(), params), "cpu")
    t0 = time.perf_counter()
    crep = cpu.serve(trace)
    cpu_s = time.perf_counter() - t0

    def bills(r):
        return (r.rid, r.status, r.bits, r.erased_bits, r.energy_j, r.n_tx,
                r.outage_s, r.uplink_bits, r.downlink_bits)
    same_bills = [bills(a) for a in rep.results] == \
        [bills(b) for b in crep.results]
    ties = []
    for a, b in zip(rep.results, crep.results):
        if (a.tokens, a.ttft_cycles) == (b.tokens, b.ttft_cycles):
            continue
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), min(len(a.tokens), len(b.tokens)))
        z = tiny_context_z(eng, trace, a.rid, a.tokens[:j])
        ties.append(dict(rid=a.rid, token=j, card=a.tokens, cpu=b.tokens,
                         ttft_card=a.ttft_cycles, ttft_cpu=b.ttft_cycles,
                         z=z))
    print(f"tiny serve card vs CPU ({cpu_s:.2f} s on the CPU): bills equal "
          f"{same_bills}; requests whose tokens or TTFT cycles differ "
          f"{len(ties)} of {len(rep.results)}", flush=True)
    for t in ties:
        print(f"  request {t['rid']}: token {t['token']}, card {t['card']} "
              f"(ttft {t['ttft_card']}) vs CPU {t['cpu']} (ttft "
              f"{t['ttft_cpu']}), forward z {t['z']:+.3e}")
    if not same_bills:
        failures.append("tiny serving bills differ between card and CPU")
    if any(abs(t["z"]) > 2 * TINY_TOL for t in ties):
        failures.append("tiny tokens differ between card and CPU away from "
                        "a near-tie")
    prof = profile_phase(eng, RequestTrace(trace.seed, trace.requests[:64]),
                         "dense", kernels={})
    summary = dict(d, serve_s=serve_s, requests_per_s=TINY_REQUESTS / serve_s,
                   warmup_s=warm, launches_in_serve=serve_launches,
                   forward_launches={k: launches[k] - serve_launches[k]
                                     for k in launches},
                   first_logits=len(firsts), max_abs_vs_forward=float(
                       err.max()), worst_over_tol=worst,
                   cpu_bills_equal=same_bills, cpu_s=cpu_s,
                   token_divergences=ties, profile_64_requests=prof)
    return launches, summary, failures


# ----------------------------------------- the FL/SL options and link
# phase 9, at the paper's full size (24,576 / 2,560 rows, N 3, J 5, Q8,
# 20 dB), one cycle each: the coordinate median, DP-FedAvg (sigma 0.5,
# C 1), Dirichlet(0.1) shards with FedProx (mu 0.1) and sampling with
# replacement (benchmarks/extensions.py's arm "dirichlet0.1_fedprox"),
# fused SL scored over the noiseless link, and the model's weights
# through Hamming(7,4) and each constellation. DP's sync redone on the
# CPU from the card's uploads: the clip norm sums in another order, so
# a privatized weight may round to the next code: at most DP_MOVED codes
# may move, each by one step, and the synced weights then lie within one
# step / N of the CPU's
DP_MOVED = 64
DP_SIGMA, DP_CLIP = 0.5, 1.0
DP_EPSILON = 9.6896             # sqrt(2 ln(1.25e5)) / 0.5


@contextlib.contextmanager
def dp_uploads(out: dict):
    """While open, keep each DP sync's inputs and output (key path, local
    weights, broadcast, synced) in out["dp"] and each privatized update
    it sends in out["privatized"], on the host."""
    from repro_torch.core import channel as CH
    from repro_torch.core import dp as DP
    from repro_torch.nn import tree_map
    host = lambda tr: tree_map(lambda a: a.detach().cpu().clone(), tr)
    sync, send = DP.fedavg_dp_through_channel, CH.transmit_pytree

    def sync_kept(key, user_params, broadcast, *a, **kw):
        r = sync(key, user_params, broadcast, *a, **kw)
        out["dp"].append((key.path, host(user_params), host(broadcast),
                          host(r[0])))
        return r

    def send_kept(draws, tree, *a, **kw):
        out["privatized"].append(host(tree))
        return send(draws, tree, *a, **kw)
    DP.fedavg_dp_through_channel, CH.transmit_pytree = sync_kept, send_kept
    try:
        yield out
    finally:
        DP.fedavg_dp_through_channel, CH.transmit_pytree = sync, send


def dp_check(run, wcfg) -> dict:
    """The card's DP sync (`dp_uploads`' record `run`) redone on the CPU
    from its local weights and the same keys: per user the privatized
    update against the card's, its Q8 codes, and the synced weights
    against the card's."""
    import torch
    from repro_torch.core import dp as DP
    from repro_torch.core import quantization as Q
    from repro_torch.core.draws import Key
    from repro_torch.nn import tree_leaves, tree_map
    path, user_params, broadcast, synced = run["dp"][0]
    key = Key(*path)
    moved, steps, d_priv, step_max = 0, 0, 0.0, 0.0
    for u in range(len(run["privatized"])):
        delta = tree_map(lambda l, b: l[u] - b, user_params, broadcast)
        cpu = DP.privatize_update(key.fold_in(u).split(2)[0], delta,
                                  DP_CLIP, DP_SIGMA)
        for a, b in zip(tree_leaves(run["privatized"][u]), tree_leaves(cpu)):
            d_priv = max(d_priv, float((a - b).abs().max()))
            qa, sa = Q.quantize(a, 8)
            qb, _ = Q.quantize(b, 8)
            diff = (qa - qb).abs()
            moved += int((diff > 0).sum())
            steps = max(steps, int(diff.max()))
            step_max = max(step_max, float(sa))
    csync, bits, eps = DP.fedavg_dp_through_channel(
        key, user_params, broadcast, wcfg, DP_CLIP, DP_SIGMA)
    n = len(run["privatized"])
    d_sync = max(float((a - torch.as_tensor(b)).abs().max())
                 for a, b in zip(tree_leaves(synced),
                                 tree_leaves(tree_map(lambda p: p[0],
                                                      csync))))
    return dict(privatized_max_abs=d_priv, codes_moved=moved,
                max_code_step=steps, synced_max_abs=d_sync,
                synced_tol=step_max / n + 1e-6, cpu_bits=bits,
                cpu_epsilon=eps)


def fedprox_gap(seed: int) -> float:
    """Largest weight difference between the card and the CPU after
    three FedProx local steps (mu 0.1, lr 0.1) from the run's init on
    user 0's first three batches of its Dirichlet shard, sampled with
    replacement, the anchor the init weights."""
    import numpy as np
    import torch
    from repro_torch.nn import tree_leaves, tree_map
    from repro_torch.runtime.fl_runtime import make_local_step_tiny
    from repro_torch.runtime.train_step import init_train_state
    from repro_torch.schemes.base import BATCH, CFG, MOMENTUM
    xu, yu = _dirichlet_shards()[0]
    idx = np.random.default_rng(seed + 1).integers(0, len(xu), (3, BATCH))
    out = {}
    for dev in ("cuda", "cpu"):
        st = init_train_state(torch.Generator().manual_seed(seed), CFG,
                              None, "sgd", MOMENTUM, dev)
        anchor = {"model": tree_map(lambda p: p.clone(),
                                    st.trainable["model"]), "codec": {}}
        step = make_local_step_tiny(CFG, None, 0.1, MOMENTUM, prox_mu=0.1,
                                    anchor=anchor)
        for i in idx:
            st, _m = step(st, {"tokens": torch.from_numpy(xu[i]).to(dev),
                               "labels": torch.from_numpy(yu[i]).to(dev)})
        out[dev] = tree_leaves(st.trainable)
    return max(float((a.cpu() - b).abs().max())
               for a, b in zip(out["cuda"], out["cpu"]))


def options_phase(seed: int, sl_run: dict, weights: dict, card_name: str,
                  shapes: dict) -> tuple:
    """Phase 9: the median, DP and Dirichlet + FedProx FL cycles on the
    card (counters set to 0 before, read after; launches by shape into
    `shapes`), their CPU checks, phase 5's fused SL model scored over
    the noiseless link on the card and the CPU, and `weights` (a flat
    89,673-element vector) through the coded and modulated links on both.
    Returns ({kernel name: launches}, summary, failures)."""
    import torch
    from repro_torch.core import coding as CODE
    from repro_torch.core import modulation as MOD
    from repro_torch.core.draws import Key
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.nn import tree_map
    from repro_torch.schemes.base import corpus
    from repro_torch.schemes.split import evaluate_sl
    counters = dict(_wire_counters(), conv_pool=cp.user_conv_pool,
                    lstm_final_state=lc.lstm_final_state)
    for f in counters.values():
        f.launches = 0
    failures, summary, secs = [], {}, {}
    dp = {"dp": [], "privatized": []}
    with launch_shapes({}) as phase_shapes:
        runs = {"fl_median": _train_run("fl_median", 1, "cuda", seed)}
        with dp_uploads(dp):
            runs["fl_dp"] = _train_run("fl_dp", 1, "cuda", seed)
        runs["fl_dirichlet0.1_fedprox"] = _train_run(
            "fl_dirichlet0.1_fedprox", 1, "cuda", seed)
        sl_wcfg = sl_run["exp"].scheme.wcfg
        sl_tr = sl_run["exp"].final_state.train.trainable
        n0 = _tiny_counts()
        t0 = time.perf_counter()
        acc_card = evaluate_sl(sl_tr, sl_wcfg, *corpus()[1],
                               perfect_eval=True)
        torch.cuda.synchronize()
        secs["sl_perfect_eval"] = time.perf_counter() - t0
        sl_launches = tuple(b - a for a, b in zip(n0, _tiny_counts()))
    launches = {k: f.launches for k, f in counters.items()}
    failures += merge_shapes(shapes, phase_shapes, launches, "options")
    for n, run in runs.items():
        rep, res = run["exp"].reports[0], run["res"]
        secs[n] = run["walls"][0]
        got = ((run["round_launches"][0],) + run["round_k34"][0],
               (run["eval_launches"][0],) + run["eval_k34"][0])
        print(f"option {n} on the card: {secs[n]:.3f} s per cycle "
              f"({card_name}); accuracy {res.accuracy[0]:.4f}; loss "
              f"{res.loss[0]:.4f}; bits {rep.bits}; n_tx {rep.n_tx}; "
              f"(K1, K3, K4) per round {got[0]}, per eval {got[1]}",
              flush=True)
        summary[n] = dict(wall_s=secs[n], accuracy=res.accuracy[0],
                          loss=res.loss[0], bits=rep.bits, n_tx=rep.n_tx,
                          launches_round=got[0], launches_eval=got[1])
        if rep.bits != 3 * FL_BITS_PER_USER:
            failures.append(f"{n} billed {rep.bits} bits, not "
                            f"{3 * FL_BITS_PER_USER}")
        if got != ((3 if n == "fl_dp" else 1, 0, 0), (0, 1, 1)):
            failures.append(f"{n}: (K1, K3, K4) per round {got[0]}, per "
                            f"eval {got[1]}")
        if not (math.isfinite(res.accuracy[0]) and math.isfinite(
                res.loss[0])):
            failures.append(f"{n}: non-finite accuracy or loss")
    # (a) the median sync on the CPU from the card's uploads
    sync = sync_check(runs["fl_median"])
    print(f"option fl_median: sync redone on the CPU, delivered equal "
          f"{sync['delivered_equal']}, median equal {sync['synced_equal']}; "
          f"the synced model scored on the CPU: |d accuracy| "
          f"{sync['abs_d_accuracy']:.5f}", flush=True)
    summary["fl_median"].update(cpu_sync=sync)
    if not (sync["delivered_equal"] and sync["synced_equal"]):
        failures.append("median sync on the card differs from the CPU's")
    # (b) DP: epsilon, and the sync redone on the CPU
    dpc = dp_check(dp, runs["fl_dp"]["wcfg"])
    eps = runs["fl_dp"]["exp"].scheme.last_epsilon
    print(f"option fl_dp: epsilon {eps:.4f}; sync redone on the CPU: "
          f"privatized updates max |d| {dpc['privatized_max_abs']:.3e}, "
          f"{dpc['codes_moved']} Q8 codes moved (largest move "
          f"{dpc['max_code_step']} step), synced max |d| "
          f"{dpc['synced_max_abs']:.3e} (tol {dpc['synced_tol']:.3e}); CPU "
          f"bits {dpc['cpu_bits']}", flush=True)
    summary["fl_dp"].update(epsilon=eps, cpu_sync=dpc)
    if round(eps, 4) != DP_EPSILON or dpc["cpu_epsilon"] != eps:
        failures.append(f"DP epsilon {eps}")
    if dpc["cpu_bits"] != 3 * FL_BITS_PER_USER or \
            dpc["codes_moved"] > DP_MOVED or dpc["max_code_step"] > 1 or \
            not dpc["synced_max_abs"] <= dpc["synced_tol"]:
        failures.append(f"DP sync on the card vs the CPU: {dpc}")
    # (c) Dirichlet + FedProx + replacement: three local steps
    gap = fedprox_gap(seed)
    shard = len(_dirichlet_shards()[0][0])
    print(f"option fl_dirichlet0.1_fedprox: {shard} rows per user; three "
          f"FedProx steps card vs CPU max |d weight| {gap:.3e} (tol "
          f"{STEP_TOL})", flush=True)
    summary["fl_dirichlet0.1_fedprox"].update(three_step_gap=gap,
                                             shard_rows=shard)
    if not gap <= STEP_TOL:
        failures.append(f"FedProx steps card vs CPU {gap}")
    # (d) the fused SL model scored over the noiseless link
    acc_cpu = evaluate_sl(tree_map(lambda a: a.cpu(), sl_tr), sl_wcfg,
                          *corpus()[1], perfect_eval=True)
    print(f"option sl_perfect_eval: accuracy card {acc_card:.4f}, CPU "
          f"{acc_cpu:.4f} (tol {ACC_TOL}); {secs['sl_perfect_eval']:.3f} s "
          f"per eval ({card_name}); (K1, K3, K4) launches {sl_launches}",
          flush=True)
    summary["sl_perfect_eval"] = dict(accuracy=acc_card, cpu_accuracy=acc_cpu,
                                      wall_s=secs["sl_perfect_eval"],
                                      launches=sl_launches)
    if abs(acc_card - acc_cpu) > ACC_TOL or sl_launches[1:] != (1, 1):
        failures.append(f"perfect_eval: card {acc_card}, CPU {acc_cpu}, "
                        f"launches {sl_launches}")
    # (e) the model's weights through the coded and modulated links
    x = weights.to("cuda")
    links = {"hamming74": lambda dv, d: CODE.transmit_quantized_coded(
        d, x.to(dv), 8, 5.0)}
    for m in MOD.SUPPORTED:
        links[m] = lambda dv, d, m=m: MOD.transmit_quantized_mod(
            d, x.to(dv), 8, 5.0, m)
    for i, (name, fn) in enumerate(links.items()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yc, extra = fn("cuda", Key(seed + 11, i).draws())
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        yh, extra_h = fn("cpu", Key(seed + 11, i).draws())
        equal = bool(torch.equal(yc.cpu(), yh))
        print(f"link {name}: {x.numel()} weights, card == CPU bit for bit "
              f"{equal}; {secs[name]:.4f} s on the card ({card_name})"
              + (f"; bits {extra}" if name == "hamming74" else
                 f"; ber {float(extra['ber']):.4e}, symbols "
                 f"{extra['symbols']}"), flush=True)
        summary[name] = dict(equal=equal, wall_s=secs[name])
        if not equal or not bool(torch.isfinite(yc).all()):
            failures.append(f"link {name}: card and CPU differ")
        if name == "hamming74" and extra != x.numel() * 14:
            failures.append(f"coded link billed {extra} bits")
    summary["seconds"] = secs
    return launches, summary, failures


# ------------------------------------------ fleets, faults and resume
# phase 10. (a) benchmarks/fleet.py's two parity fleets on its corpus
# (4,096 / 512 rows, seed 0) under the loop engine and the fleet engine
# on the card, the loop also on the CPU: every round's bill equal
# between the engines and between card and CPU, bit for bit, accuracy
# card vs CPU within ACC_TOL, and parity_mixed_4 billing the JAX
# package's MIXED4_ROUND_BITS a round (no ARQ, so no draw enters it).
# (b) kill at cycle KILL_AT of RESUME_CYCLES and resume, at the full
# corpus: the resumed run equal to the uninterrupted one, bit for bit.
# The training plane: an all-FL fleet of two groups, two of three
# clients a round, under FleetScheme(train="on") beside the loop on the
# card: bills, losses and global weights equal, K1 once per active group.
# (c) the synthetic billing plane at FLEET_SCALE clients (rounds), one
# 10^4 round again on the CPU, bit for bit. (d) launch/train.py's
# --fleet-* flags on the card: a 6-client FL fleet on the training plane
# and a synthetic fleet of LAUNCH_FLEET clients.
FLEET_N_TRAIN, FLEET_N_TEST = 4096, 512
MIXED4_ROUND_BITS = 717_384 + 358_692 + 2 * 1_835_008 + 2 * 917_504
RESUME_CYCLES, KILL_AT = 4, 2
FLEET_SCALE = ((10_000, 3), (100_000, 2))
TRAIN_PLANE_CYCLES = 3
LAUNCH_FLEET = 10_000
FLEET_BILLS = ("bits", "n_tx", "energy_j", "erased_bits", "outage_s",
               "steps")


def _parity_fleets() -> dict:
    """name -> (specs, cycles, scheme options): benchmarks/fleet.py's
    parity_mixed_4 and parity_faulty_6."""
    from repro_torch.configs import WirelessConfig
    from repro_torch.schemes import ClientSpec, FaultPlan, \
        ParticipationPolicy
    base = WirelessConfig(mode="fl", quant_bits=8)
    arq = WirelessConfig(mode="fl", quant_bits=8, arq_max_tx=3,
                         ge_p_gb=0.2, arq_backoff_s=0.01, snr_db=4.0)
    mixed = [ClientSpec.fl(base, snr_db=20.0),
             ClientSpec.fl(base, snr_db=6.0, quant_bits=4),
             ClientSpec.sl(base, snr_db=12.0, quant_bits=16),
             ClientSpec.sl(base, snr_db=20.0)]
    faulty = [ClientSpec.fl(arq), ClientSpec.fl(arq, snr_db=8.0),
              ClientSpec.sl(arq, quant_bits=16),
              ClientSpec.sl(arq, quant_bits=16, local_epochs=2),
              ClientSpec.cl(arq), ClientSpec.fl(arq, snr_db=12.0)]
    return {"parity_mixed_4": (mixed, 2, {}),
            "parity_faulty_6": (faulty, 3, dict(
                policy=ParticipationPolicy.bernoulli(0.8), quorum=0.3,
                fault_plan=FaultPlan(seed=1, p_outage=0.25,
                                     p_dropout=0.25)))}


def _train_plane_specs() -> list:
    """Three FL clients over two radios (two groups)."""
    from repro_torch.configs import WirelessConfig
    from repro_torch.schemes import ClientSpec
    base = WirelessConfig(mode="fl", quant_bits=8)
    return [ClientSpec.fl(base, snr_db=20.0), ClientSpec.fl(base, snr_db=20.0),
            ClientSpec.fl(base, snr_db=6.0, quant_bits=4)]


def _fleet_run(scheme, cycles: int, seed: int, data=None, **exp_kw):
    """`scheme` through `Experiment`, with K1's, K3's and K4's launches
    counted inside each round and each eval apart, each cycle's host
    seconds, and the fleet engine's per-round detail and timing kept."""
    import torch
    from repro_torch.schemes import Experiment
    rounds, evals, walls, details = [], [], [], []
    sync = scheme.device.type == "cuda"

    def counted(fn, out):
        def run(*a):
            n0 = _tiny_counts()
            r = fn(*a)
            if sync:
                torch.cuda.synchronize()
            out.append(tuple(b - a for a, b in zip(n0, _tiny_counts())))
            return r
        return run
    scheme.round = counted(scheme.round, rounds)
    scheme.evaluate = counted(scheme.evaluate, evals)
    t = [time.perf_counter()]

    def on_cycle(cyc, acc, rep):
        walls.append(time.perf_counter() - t[0])
        if getattr(scheme, "last_round_detail", None) is not None:
            details.append((dict(scheme.last_round_detail),
                            dict(scheme.last_round_seconds)))
        t[0] = time.perf_counter()
    exp = Experiment(scheme, cycles=cycles, seed=seed, data=data,
                     on_cycle=on_cycle, **exp_kw)
    res = exp.run()
    return dict(exp=exp, res=res, rounds=rounds, evals=evals, walls=walls,
                details=details)


def _bills(exp) -> list:
    return [tuple(getattr(r, f) for f in FLEET_BILLS) for r in exp.reports]


def _client_bills(exp) -> list:
    """Each round's per-client bills and decisions (not the losses)."""
    return [[(c.name, c.status, c.bits, c.n_tx, c.energy_j, c.erased_bits,
              c.weight, c.steps, c.est_round_s) for c in r.clients]
            for r in exp.reports]


def _expected_k1(scheme, rep) -> int:
    """K1 launches a population round makes: one per FL group with an
    active member, two per SL step."""
    groups = sum(1 for g in scheme._groups
                 if any(rep.clients[i].steps > 0 for i in g.members))
    return groups + 2 * sum(rep.clients[i].steps for i in scheme._sl_idx)


def _detail_equal(loop_rep, detail) -> bool:
    return all(
        (c.bits, c.n_tx, c.energy_j, c.erased_bits, c.status, c.weight,
         c.est_round_s) == (detail["bits"][i], detail["n_tx"][i],
                            detail["energy_j"][i], detail["erased_bits"][i],
                            detail["status_names"][i], detail["weight"][i],
                            detail["est_round_s"][i])
        for i, c in enumerate(loop_rep.clients))


def fleet_parity(seed: int, card_name: str) -> tuple:
    """Phase 10 (a): each parity fleet under both engines on the card and
    the loop on the CPU (one intra-op thread). Returns (summary,
    failures)."""
    import torch
    from repro_torch.schemes import (ClientBatch, FleetScheme,
                                     PopulationScheme, corpus)
    data = corpus(FLEET_N_TRAIN, FLEET_N_TEST, seed)
    summary, failures = {}, []
    for name, (specs, cycles, kw) in _parity_fleets().items():
        loop = _fleet_run(PopulationScheme(None, specs, device="cuda",
                                           **kw), cycles, seed, data)
        fleet = _fleet_run(FleetScheme(None, ClientBatch.from_specs(specs),
                                       device="cuda", **kw),
                           cycles, seed, data)
        n_thr = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cpu = _fleet_run(PopulationScheme(None, specs, device="cpu",
                                              **kw), cycles, seed, data)
        finally:
            torch.set_num_threads(n_thr)
        le, fe, ce = loop["exp"], fleet["exp"], cpu["exp"]
        engines_equal = _bills(le) == _bills(fe) and _detail_equal(
            le.reports[-1], fleet["details"][-1][0])
        cpu_equal = (_bills(le) == _bills(ce)
                     and _client_bills(le) == _client_bills(ce))
        d_acc = max(abs(a - b) for a, b in zip(loop["res"].accuracy,
                                               cpu["res"].accuracy))
        want_k1 = [_expected_k1(le.scheme, r) for r in le.reports]
        sl_eval = bool(le.scheme._sl_idx)
        want_eval = (1 if sl_eval else 0, 1, 1)
        launches_ok = ([r[0] for r in loop["rounds"]] == want_k1
                       and all(r[1:] == (0, 0) for r in loop["rounds"])
                       and all(e == want_eval for e in loop["evals"])
                       and all(r == (0, 0, 0) for r in fleet["rounds"])
                       and all(e == (0, 1, 1) for e in fleet["evals"]))
        bits = [r.bits for r in le.reports]
        statuses = [{s: [c.status for c in r.clients].count(s)
                     for s in {c.status for c in r.clients}}
                    for r in le.reports]
        print(f"fleet {name} ({len(specs)} clients, {cycles} cycles): bits "
              f"per round {bits}; erased {[r.erased_bits for r in le.reports]}"
              f"; statuses {statuses}; loop = fleet engine on the card "
              f"{engines_equal}; card = CPU (loop) {cpu_equal}; accuracy "
              f"card {loop['res'].accuracy} CPU {cpu['res'].accuracy} "
              f"(|d| {d_acc:.4f}, tol {ACC_TOL}); (K1, K3, K4) per round "
              f"loop {loop['rounds']} (K1 wanted {want_k1}), fleet "
              f"{fleet['rounds']}; per eval loop {loop['evals']}, fleet "
              f"{fleet['evals']}; s per cycle loop "
              f"{['%.3f' % w for w in loop['walls']]}, fleet "
              f"{['%.4f' % w for w in fleet['walls']]}, CPU loop "
              f"{['%.3f' % w for w in cpu['walls']]} ({card_name})",
              flush=True)
        summary[name] = dict(
            bits=bits, erased_bits=[r.erased_bits for r in le.reports],
            statuses=statuses, engines_equal=engines_equal,
            cpu_equal=cpu_equal, accuracy=loop["res"].accuracy,
            cpu_accuracy=cpu["res"].accuracy, launches_round=loop["rounds"],
            launches_eval=loop["evals"], fleet_launches=fleet["rounds"],
            wall_s=loop["walls"], fleet_wall_s=fleet["walls"],
            cpu_wall_s=cpu["walls"])
        if not engines_equal:
            failures.append(f"{name}: the loop and fleet engines bill apart")
        if not cpu_equal:
            failures.append(f"{name}: card and CPU bills differ")
        if not d_acc <= ACC_TOL:
            failures.append(f"{name}: card vs CPU accuracy {d_acc}")
        if not launches_ok:
            failures.append(f"{name}: launches per round {loop['rounds']} "
                            f"(K1 wanted {want_k1}) / eval {loop['evals']}, "
                            f"fleet {fleet['rounds']} / {fleet['evals']}")
        if name == "parity_mixed_4" and bits != [MIXED4_ROUND_BITS] * cycles:
            failures.append(f"{name} billed {bits}, not "
                            f"{MIXED4_ROUND_BITS} a round")
        if not all(math.isfinite(a) for a in loop["res"].accuracy):
            failures.append(f"{name}: non-finite accuracy")
    summary["train_plane"], f = train_plane_parity(seed, card_name, data)
    return summary, failures + f


def train_plane_parity(seed: int, card_name: str, data) -> tuple:
    """The fleet engine's training plane on the card beside the loop:
    equal bills and losses, `torch.equal` global weights, K1 once per
    active FL group a round in both. Returns (summary, failures)."""
    import torch
    from repro_torch.nn import tree_leaves
    from repro_torch.schemes import (ClientBatch, FleetScheme,
                                     ParticipationPolicy, PopulationScheme)
    kw = dict(policy=ParticipationPolicy.uniform(2))
    loop = _fleet_run(PopulationScheme(None, _train_plane_specs(),
                                       device="cuda", **kw),
                      TRAIN_PLANE_CYCLES, seed, data)
    scheme = FleetScheme(None, ClientBatch.from_specs(_train_plane_specs()),
                         train="on", device="cuda", **kw)
    fleet = _fleet_run(scheme, TRAIN_PLANE_CYCLES, seed, data)
    le, fe = loop["exp"], fleet["exp"]
    bills_equal = (_bills(le) == _bills(fe)
                   and [r.loss for r in le.reports] == [r.loss for r in
                                                       fe.reports])
    gl = tree_leaves(le.final_state.train.global_trainable["model"])
    gf = tree_leaves(fe.final_state.train.glob["model"])
    weights_equal = len(gl) == len(gf) > 0 and all(
        a.device.type == "cuda" and torch.equal(a, b)
        for a, b in zip(gf, gl))
    want_k1 = [_expected_k1(le.scheme, r) for r in le.reports]
    launches_ok = all(
        [r[0] for r in run["rounds"]] == want_k1
        and all(r[1:] == (0, 0) for r in run["rounds"])
        and all(e == (0, 1, 1) for e in run["evals"])
        for run in (loop, fleet))
    statuses = [[c.status for c in r.clients] for r in le.reports]
    print(f"fleet train_plane_fl_3 (2 groups, uniform(2), "
          f"{TRAIN_PLANE_CYCLES} cycles): train_on {scheme.train_on}; bits "
          f"per round {[r.bits for r in le.reports]}; statuses {statuses}; "
          f"loop = fleet bills and losses {bills_equal}; global weights "
          f"torch.equal {weights_equal}; accuracy loop "
          f"{loop['res'].accuracy} fleet {fleet['res'].accuracy}; (K1, K3, "
          f"K4) per round loop {loop['rounds']} fleet {fleet['rounds']} (K1 "
          f"wanted {want_k1}); s per cycle loop "
          f"{['%.3f' % w for w in loop['walls']]}, fleet "
          f"{['%.3f' % w for w in fleet['walls']]} ({card_name})",
          flush=True)
    failures = []
    if not scheme.train_on:
        failures.append("train_plane: the fleet is not on its training plane")
    if not bills_equal:
        failures.append("train_plane: the loop and fleet engines bill apart")
    if not weights_equal:
        failures.append("train_plane: global weights differ between engines")
    if not launches_ok:
        failures.append(f"train_plane: launches loop {loop['rounds']} / "
                        f"{loop['evals']}, fleet {fleet['rounds']} / "
                        f"{fleet['evals']} (K1 wanted {want_k1})")
    return dict(bits=[r.bits for r in le.reports], bills_equal=bills_equal,
                weights_equal=weights_equal, statuses=statuses,
                accuracy=fleet["res"].accuracy, launches_round=fleet["rounds"],
                k1_wanted=want_k1), failures


def _resume_schemes() -> dict:
    """name -> a function making the scheme: tests/test_resume.py's
    faulty FL, and parity_mixed_4 under a FaultPlan."""
    from repro_torch.configs import WirelessConfig
    from repro_torch.schemes import FaultPlan, build_scheme
    mixed = _parity_fleets()["parity_mixed_4"][0]
    return {
        "fl_faulty": lambda: build_scheme(WirelessConfig(
            mode="fl", quant_bits=8, n_users=3, local_steps=2,
            arq_max_tx=2, arq_min_f2=0.4, ge_p_gb=0.2, ge_p_bg=0.6,
            arq_backoff_s=0.01)),
        "mixed_4_faultplan": lambda: build_scheme(
            WirelessConfig(mode="fl", quant_bits=8), clients=mixed,
            fault_plan=FaultPlan(seed=0, p_outage=0.25, p_dropout=0.25)),
    }


def _state_leaves(train) -> list:
    from repro_torch.checkpoint import ckpt as CKPT
    out = []
    CKPT._map_with_path(lambda k, leaf: out.append((k, leaf)) or leaf,
                        train)
    return out


def fleet_resume(seed: int, card_name: str) -> tuple:
    """Phase 10 (b): each of `_resume_schemes` for RESUME_CYCLES cycles
    straight, and killed after KILL_AT then resumed from its snapshot,
    on the card at the full corpus. Returns (summary, failures)."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    summary, failures = {}, []
    for name, make in _resume_schemes().items():
        t0 = time.perf_counter()
        straight = _fleet_run(make(), RESUME_CYCLES, seed)
        with tempfile.TemporaryDirectory() as ck:
            _fleet_run(make(), KILL_AT, seed, checkpoint_dir=ck,
                       checkpoint_every=1)
            resumed = _fleet_run(make(), RESUME_CYCLES, seed,
                                 resume_from=ck)
        a, b = straight, resumed
        la = _state_leaves(a["exp"].final_state.train)
        lb = _state_leaves(b["exp"].final_state.train)
        weights_equal = [k for k, _ in la] == [k for k, _ in lb] and all(
            torch.equal(x, y) if torch.is_tensor(x) else
            bool(np.array_equal(x, y)) for (_, x), (_, y) in zip(la, lb))
        on_card = all(x.device.type == "cuda" for _, x in lb
                      if torch.is_tensor(x))
        same = dict(
            accuracy=a["res"].accuracy == b["res"].accuracy,
            loss=a["res"].loss == b["res"].loss,
            total_bits=a["res"].total_bits == b["res"].total_bits,
            reports=[dataclasses.asdict(r) for r in a["exp"].reports]
            == [dataclasses.asdict(r) for r in b["exp"].reports],
            weights=weights_equal, on_card=on_card)
        secs = time.perf_counter() - t0
        print(f"resume {name}: {RESUME_CYCLES} cycles straight vs killed "
              f"after {KILL_AT} and resumed: equal {same}; accuracy "
              f"{a['res'].accuracy}; total bits {a['res'].total_bits}; "
              f"{len(lb)} state leaves; {secs:.1f} s ({card_name})",
              flush=True)
        summary[name] = dict(same, accuracy_list=a["res"].accuracy,
                             total_bits_value=a["res"].total_bits,
                             wall_s=secs, leaves=len(lb))
        if not all(same.values()):
            failures.append(f"resume {name}: {same}")
    return summary, failures


def fleet_scale(seed: int, card_name: str) -> tuple:
    """Phase 10 (c): benchmarks/fleet.py's synthetic fleet at each of
    FLEET_SCALE on the card (the billing plane), its seconds per round
    and the SL replay's share, and one 10^4 round again on the CPU, bit
    for bit. Returns (summary, failures)."""
    import numpy as np
    from repro_torch.schemes import (ClientBatch, FleetScheme,
                                     ParticipationPolicy, corpus)
    data = corpus(FLEET_N_TRAIN, FLEET_N_TEST, seed)

    def fleet(n, device):
        batch = ClientBatch.synthetic(
            n, seed=0, arq_max_tx=3, arq_backoff_s=0.001, ge_p_gb=0.05,
            sl_frac=0.3, compute_s_range=(0.0, 2.0), p_outage=0.01,
            p_dropout=0.01)
        return FleetScheme(None, batch, deadline_s=1e9, device=device,
                           policy=ParticipationPolicy.bernoulli(0.5))
    summary, failures = {}, []
    for n, rounds in FLEET_SCALE:
        run = _fleet_run(fleet(n, "cuda"), rounds, seed, data)
        reps = run["exp"].reports
        shares = [s["sl_replay"] / s["round"] for _, s in run["details"]]
        steady = run["walls"][1:] or run["walls"]
        rec = dict(wall_s=run["walls"],
                   steady_s=sum(steady) / len(steady),
                   round_s=[s["round"] for _, s in run["details"]],
                   sl_replay_s=[s["sl_replay"] for _, s in run["details"]],
                   sl_replay_share=shares,
                   n_active=[r.metrics["n_active"] for r in reps],
                   bits=[r.bits for r in reps],
                   erased_bits=[r.erased_bits for r in reps],
                   status_counts=[r.metrics["fleet"]["status_counts"]
                                  for r in reps],
                   launches_round=run["rounds"], launches_eval=run["evals"])
        for c, r in enumerate(reps):
            print(f"fleet synthetic n={n} round {c}: {run['walls'][c]:.3f} s"
                  f" (round {rec['round_s'][c]:.3f} s, SL replay "
                  f"{rec['sl_replay_s'][c]:.3f} s = {shares[c]:.3f}); "
                  f"n_active {rec['n_active'][c]}; bits {r.bits}; erased "
                  f"{r.erased_bits}; {rec['status_counts'][c]} "
                  f"({card_name})", flush=True)
        print(f"fleet synthetic n={n}: steady {rec['steady_s']:.3f} s per "
              f"round over rounds 1..{rounds - 1}", flush=True)
        if any(r != (0, 0, 0) for r in run["rounds"]) or \
                any(e != (0, 1, 1) for e in run["evals"]):
            failures.append(f"synthetic n={n}: launches per round "
                            f"{run['rounds']}, per eval {run['evals']}")
        if n == 10_000:
            cpu = _fleet_run(fleet(n, "cpu"), 1, seed, data)
            det, cdet = run["details"][0][0], cpu["details"][0][0]
            equal = _bills(run["exp"])[:1] == _bills(cpu["exp"]) and all(
                np.array_equal(det[k], cdet[k], equal_nan=True)
                for k in ("status", "bits", "n_tx", "energy_j",
                          "erased_bits", "weight", "est_round_s",
                          "drop_frac"))
            rec["cpu_round0_equal"] = equal
            rec["cpu_round_s"] = cpu["walls"][0]
            print(f"fleet synthetic n={n} round 0 on the CPU: bills and "
                  f"per-client detail equal {equal} "
                  f"({cpu['walls'][0]:.3f} s)", flush=True)
            if not equal:
                failures.append(f"synthetic n={n}: card and CPU bills differ")
        summary[f"synthetic_{n}"] = rec
    return summary, failures


def fleet_launch(seed: int, card_name: str) -> tuple:
    """Phase 10 (d): `launch/train.py --fleet-*` on the card, 2 rounds
    each: a 6-client FL fleet (engine `fleet`, 4 a round: the training
    plane, one group, so K1 once a round) and a synthetic fleet of
    LAUNCH_FLEET clients, 30 % SL. Returns (summary, failures)."""
    from repro_torch.launch import train
    common = ["--arch", "paper-tinylstm", "--steps", "2", "--seed",
              str(seed), "--n-train", str(FLEET_N_TRAIN), "--n-test",
              str(FLEET_N_TEST)]
    runs = {"fl_6_fleet": ["--fleet-size", "6", "--fleet-engine", "fleet",
                           "--fleet-sample", "4"],
            f"synthetic_{LAUNCH_FLEET}": [
                "--fleet-size", str(LAUNCH_FLEET), "--fleet-engine",
                "synthetic", "--fleet-sl-frac", "0.3", "--fleet-sample",
                "0"]}
    summary, failures = {}, []
    for name, argv in runs.items():
        n0 = _tiny_counts()
        t0 = time.perf_counter()
        out = train.main(common + argv)
        secs = time.perf_counter() - t0
        k = tuple(b - a for a, b in zip(n0, _tiny_counts()))
        exp = out["experiment"]
        scheme = exp.scheme
        reps = exp.reports
        ok = (scheme.device.type == "cuda" and len(reps) == 2
              and all(math.isfinite(a) for a in out["result"].accuracy)
              and all(math.isfinite(r.bits) and r.bits > 0 for r in reps))
        if name == "fl_6_fleet":
            # one group, 4 of 6 clients a round; FL evaluates with no wire
            ok = ok and scheme.train_on and k == (2, 2, 2) and all(
                r.metrics["n_active"] == 4 for r in reps)
        else:
            ok = ok and not scheme.train_on and all(
                sum(r.metrics["fleet"]["status_counts"].values())
                == LAUNCH_FLEET for r in reps)
        print(f"launch.train {name}: {secs:.1f} s; bits per round "
              f"{[r.bits for r in reps]}; (K1, K3, K4) {k}; accuracy "
              f"{out['result'].accuracy}; ok {ok} ({card_name})", flush=True)
        summary[name] = dict(wall_s=secs, bits=[r.bits for r in reps],
                             launches=k, ok=ok)
        if not ok:
            failures.append(f"launch.train {name}: {summary[name]}")
    return summary, failures


def fleet_phase(seed: int, card_name: str, shapes: dict) -> tuple:
    """Phase 10: engine parity, kill and resume, and the synthetic fleet
    on the card (counters set to 0 before, read after; K1's, K3's and
    K4's launches by shape into `shapes`). Returns ({kernel name:
    launches}, summary, failures)."""
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.prefill_attention import ops as pre
    counters = dict(_wire_counters(), conv_pool=cp.user_conv_pool,
                    lstm_final_state=lc.lstm_final_state,
                    decode_attention=dec.gqa_decode,
                    paged_decode_attention=dec.gqa_decode_paged,
                    prefill_attention=pre.gqa_prefill,
                    paged_prefill_attention=pre.gqa_prefill_paged)
    for f in counters.values():
        f.launches = 0
    summary, failures, secs = {}, [], {}
    with launch_shapes({}) as phase_shapes:
        for part, fn in (("parity", fleet_parity), ("resume", fleet_resume),
                         ("scale", fleet_scale),
                         ("launch", fleet_launch)):
            t0 = time.perf_counter()
            summary[part], f = fn(seed, card_name)
            secs[part] = time.perf_counter() - t0
            failures += f
    launches = {k: f.launches for k, f in counters.items()}
    failures += merge_shapes(shapes, phase_shapes, launches, "fleets")
    attn = {k: launches[k] for k in ("decode_attention",
                                     "paged_decode_attention",
                                     "prefill_attention",
                                     "paged_prefill_attention")}
    if any(attn.values()):
        failures.append(f"fleets launched attention kernels {attn}")
    for k in ("packed_wire_mean_2d", "quant_channel_2d",
              "packed_wire_2d_philox"):
        if launches[k]:
            failures.append(f"{k} launched on the fleet path")
    summary["seconds"] = secs
    print(f"fleet phase parts: {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}",
          flush=True)
    return launches, summary, failures


# ------------------------------------ qwen1.5-0.5b training (P15, dense)
# phase 11. (a) qwen1.5-0.5b at full width and depth (24 layers, d_model
# 1024, 16 heads, d_ff 2816, vocab 151,936; random weights from --seed)
# on the synthetic Zipf corpus (512 / 128 rows, seq 128, batch 8, lr
# 3e-4) through `build_scheme` + `Experiment` or the training CLI
# (QWEN_CLI): CL (AdamW, corpus over a 20 dB link) and SL (split 2,
# compress 4, Q8, 20 dB, AdamW), 2 cycles of 5 steps; FL (3 users, J 5,
# Q8, 20 dB, SGD): one barrier cycle through K1, one with use_kernel
# through K2, 2 delayed cycles at Q4 on the int4 wire. (b) the same schemes at the reduced config (2 layers, d_model
# 256, vocab 1,024), 2 cycles on the card and on the CPU: bills equal,
# losses within LOSS_TOL, accuracy within ACC_TOL; one more FL cycle's
# uploads synced through K1 and K2 on the card and their plain versions
# on the CPU, bit for bit. (c) K2 at one stacked [24, 1024, 1024] leaf of
# the qwen sync and K1 at the SL leg, against their plain versions, timed;
# K1 and K2 at the whole sync against theirs, slab by slab
QWEN = "qwen1.5-0.5b"
SCALED_N_TRAIN, SCALED_N_TEST, SCALED_STEPS = 512, 128, 5
QWEN_PARAMS = 463_987_712
QWEN_SL_STEP_BITS = 4_194_304      # 2 legs x 8 x 128 x 1024 / 4 x Q8
QWEN_CL_BITS = 512 * 128 * 18      # 18-bit token ids (vocab 151,936)
QWEN_LEAF_ROWS = 24 * 1024 * 1024 // 256      # one stacked attention leaf
SYNC_SLAB_ROWS = 1 << 16     # rows a slab of the plain version at the sync
ATTN_ROWS = ("decode_attention", "paged_decode_attention",
             "prefill_attention", "paged_prefill_attention")


def _scaled_runs() -> dict:
    """name -> (WirelessConfig, scheme options, cycles) of phase 11."""
    from repro_torch.configs import WirelessConfig
    fl = dict(mode="fl", quant_bits=8, snr_db=20.0, n_users=3,
              local_steps=5)
    steps = dict(optimizer="adamw", steps_per_cycle=SCALED_STEPS)
    return {
        "cl": (WirelessConfig(mode="cl", snr_db=20.0), steps, 2),
        "sl": (WirelessConfig(mode="sl", quant_bits=8, snr_db=20.0,
                              split_layer=2, compress_factor=4), steps, 2),
        "fl_k1": (WirelessConfig(**fl), {}, 1),
        "fl_k2": (WirelessConfig(use_kernel=True, **fl), {}, 1),
        "fl_delayed_int4": (WirelessConfig(**dict(fl, quant_bits=4),
                                           wire_dtype="int4",
                                           sync="delayed"), {}, 2),
    }


# the runs driven through the training CLI (launch/train.py), as a user
# types them: the flags give _scaled_runs()'s settings, which the run
# checks on the scheme the CLI built
QWEN_CLI = {
    "sl": ["--mode", "sl", "--steps", str(2 * SCALED_STEPS), "--cycle-steps",
           str(SCALED_STEPS), "--split-layer", "2"],
    "fl_k2": ["--mode", "fl", "--steps", "5", "--use-kernel"],
}


def _all_counters() -> dict:
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.prefill_attention import ops as pre
    return dict(_wire_counters(), conv_pool=cp.user_conv_pool,
                lstm_final_state=lc.lstm_final_state,
                decode_attention=dec.gqa_decode,
                paged_decode_attention=dec.gqa_decode_paged,
                prefill_attention=pre.gqa_prefill,
                paged_prefill_attention=pre.gqa_prefill_paged)


@contextlib.contextmanager
def _sync_clock(log: dict):
    """While open, add the synchronized wall seconds of every stacked
    send (`wire.transmit_stacked` / `transmit_stacked_mean`, the FL
    sync) and the host seconds of every flip-word draw
    (`Draws.words_u32`) into `log`."""
    import torch
    from repro_torch.core import wire as W
    from repro_torch.core.draws import Draws
    kept = [(W, "transmit_stacked"), (W, "transmit_stacked_mean"),
            (Draws, "words_u32")]
    fns = [getattr(o, a) for o, a in kept]

    def timed(fn, what, sync):
        def call(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            log[what] = log.get(what, 0.0) + time.perf_counter() - t0
            return out
        return call
    W.transmit_stacked = timed(fns[0], "sync_s", True)
    W.transmit_stacked_mean = timed(fns[1], "sync_s", True)
    Draws.words_u32 = timed(fns[2], "words_host_s", False)
    try:
        yield log
    finally:
        for (o, a), f in zip(kept, fns):
            setattr(o, a, f)


def _peak_rss_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _counted(scheme, kinds: list, step_losses=None):
    """Wrap `scheme.round` / `scheme.evaluate` (and `scheme._step`) so
    every call appends (kind, launches by kernel, seconds) to `kinds`
    (and each step's loss to `step_losses`)."""
    import torch
    counters = _all_counters()

    def wrap(fn, kind):
        def call(*a, **kw):
            n0 = {k: f.launches for k, f in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            kinds.append((kind, {k: f.launches - n0[k]
                                 for k, f in counters.items()},
                          time.perf_counter() - t0))
            return out
        return call
    scheme.round = wrap(scheme.round, "round")
    scheme.evaluate = wrap(scheme.evaluate, "eval")
    if step_losses is not None:
        step = scheme._step

        def logged(*a, **kw):
            st, m = step(*a, **kw)
            if not m["loss"].is_meta:     # not the FLOP count's pass
                step_losses.append(float(m["loss"]))
            return st, m
        scheme._step = logged


def _qwen_run(name: str, seed: int, card_name: str, profile_one: bool):
    """One phase-11 run at full width on the card. Returns its record."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.schemes import Experiment, build_scheme
    wcfg, opts, cycles = _scaled_runs()[name]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kinds, losses, clock = [], [], {}
    if name in QWEN_CLI:
        from repro_torch.launch import train
        kept = train.build_scheme

        def counted_scheme(*a, **kw):
            sch = kept(*a, **kw)
            _counted(sch, kinds, losses if wcfg.mode != "fl" else None)
            return sch
        train.build_scheme = counted_scheme
        try:
            with _sync_clock(clock):
                out = train.main(["--arch", QWEN, "--seed", str(seed)]
                                 + QWEN_CLI[name])
        finally:
            train.build_scheme = kept
        exp, res = out["experiment"], out["result"]
        scheme = exp.scheme
        del out
        same = (scheme.wcfg == wcfg and len(exp.reports) == cycles
                and all(getattr(scheme, k) == v for k, v in opts.items()))
    else:
        scheme = build_scheme(wcfg, cfg=get_arch(QWEN), device="cuda",
                              **opts)
        _counted(scheme, kinds, losses if wcfg.mode != "fl" else None)
        exp = Experiment(scheme, cycles=cycles, seed=seed,
                         n_train=SCALED_N_TRAIN, n_test=SCALED_N_TEST)
        with _sync_clock(clock):
            res = exp.run()
        same = True
    wall = time.perf_counter() - t0
    if profile_one:
        prof = _profile_scaled(exp, scheme, name, seed)
    main, extra = kinds[:-1] if profile_one else kinds, \
        kinds[-1:] if profile_one else []
    rec = dict(bits=[r.bits for r in exp.reports],
               n_tx=[r.n_tx for r in exp.reports],
               loss=res.loss, accuracy=res.accuracy, step_losses=losses,
               init_bits=(exp.init_delivery.bits if exp.init_delivery
                          else None),
               total_bits=res.total_bits,
               round_s=[s for k, _, s in main if k == "round"],
               eval_s=[s for k, _, s in main if k == "eval"],
               rounds=[c for k, c, _ in main if k == "round"],
               evals=[c for k, c, _ in main if k == "eval"],
               profiled_rounds=[c for _, c, _ in extra],
               wall_s=wall, max_memory_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30, peak_rss_gib=_peak_rss_gib(),
               user_flops=res.user_flops, server_flops=res.server_flops,
               entry="launch.train" if name in QWEN_CLI else
               "build_scheme + Experiment", settings_as_asked=same, **clock)
    if profile_one:
        rec["profile"] = prof
    if name == "sl":
        rec["dry_run"] = _dry_run_bytes(scheme, exp, seed)
    del exp, scheme
    torch.cuda.empty_cache()
    print(f"qwen {name} through {rec['entry']}: {cycles} cycles, "
          f"{wall:.1f} s (round "
          f"{[round(s, 3) for s in rec['round_s']]} s, eval "
          f"{[round(s, 3) for s in rec['eval_s']]} s); sync "
          f"{rec.get('sync_s', 0.0):.2f} s of which flip-word draws "
          f"{rec.get('words_host_s', 0.0):.2f} s on the host; peak RSS "
          f"{rec['peak_rss_gib']:.2f} GiB; max_memory_allocated "
          f"{rec['max_memory_gib']:.2f} GiB; bits {rec['bits']}; n_tx "
          f"{rec['n_tx']}; init {rec['init_bits']}; loss {res.loss} "
          f"(steps {[round(x, 4) for x in losses]}); accuracy "
          f"{res.accuracy} ({card_name})", flush=True)
    return rec


def _profile_scaled(exp, scheme, name: str, seed: int) -> dict:
    """One more CL step (or FL cycle) from the run's final state under
    torch.profiler, device activity only (an FL cycle launches ~130,000
    kernels; host op events would multiply the trace's processing
    time): the device's idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    state = exp.final_state
    rng = np.random.default_rng(seed + 11)
    batch = scheme.cycle_batches(state, rng, 99)
    if scheme.mode == "cl":
        batch = batch[:1]
    key = scheme.round_key(seed, 99)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scheme.round(state, batch, key, 3e-4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _idle_summary(prof, wall_us, f"qwen {name}, one "
                         f"{'step' if scheme.mode == 'cl' else 'cycle'}")


def _fl_sync_rows(n_users: int) -> int:
    """K1's rows at qwen1.5-0.5b's FL sync: n_users x the plan's rows
    (each leaf padded to whole 256-wide rows, the total to 8)."""
    from repro_torch.configs import get_arch
    from repro_torch.schemes.scaled import packet_sizes
    rows = sum(-(-int(s) // 256) for s in packet_sizes(get_arch(QWEN)))
    return n_users * (-(-rows // 8) * 8)


def _qwen_checks(runs: dict) -> list:
    """The phase-11 gates on the full-width runs."""
    import math
    failures = []
    k1, k2 = "packed_wire_2d", "packed_wire_mean_2d"

    def want(name, ok, what):
        if not ok:
            failures.append(f"qwen {name}: {what}")
    for name, r in runs.items():
        want(name, all(math.isfinite(x) for x in r["loss"] + r["step_losses"]),
             f"a loss is not finite {r['loss']}")
        want(name, r["settings_as_asked"], f"{r['entry']} did not build "
             f"the run's settings")
        for c in r["rounds"] + r["evals"]:
            want(name, not any(c[k] for k in ("conv_pool",
                                              "lstm_final_state",
                                              "quant_channel_2d",
                                              "packed_wire_2d_philox")
                                + ATTN_ROWS), f"K3-K10 launched: {c}")
    cl, sl = runs["cl"], runs["sl"]
    want("cl", cl["init_bits"] == QWEN_CL_BITS, f"init bits "
         f"{cl['init_bits']}")
    want("cl", all(c[k1] == c[k2] == 0 for c in cl["rounds"] + cl["evals"]),
         "CL launched the wire")
    want("sl", sl["bits"] == [SCALED_STEPS * QWEN_SL_STEP_BITS] * 2,
         f"bits {sl['bits']}")
    want("sl", all(c[k1] == 2 * SCALED_STEPS and c[k2] == 0
                   for c in sl["rounds"]), "K1 not twice a step")
    want("sl", all(c[k1] == SCALED_N_TEST // 8 for c in sl["evals"]),
         "K1 not once an eval slice")
    for name in ("cl", "sl"):
        r = runs[name]
        want(name, r["loss"][-1] < r["step_losses"][0],
             f"loss did not drop {r['step_losses']}")
    for name, bits, kern in (("fl_k1", 8, k1), ("fl_k2", 8, k2),
                             ("fl_delayed_int4", 4, k1)):
        r = runs[name]
        per_user = [b / 3 for b in r["bits"]]
        want(name, per_user == [float(bits * QWEN_PARAMS)] * len(r["bits"]),
             f"bits per user {per_user}")
        want(name, r["n_tx"] == [42.0] * len(r["bits"]), f"n_tx {r['n_tx']}")
        other = k2 if kern == k1 else k1
        want(name, all(c[kern] == 1 and c[other] == 0 for c in r["rounds"]),
             f"{kern} not once a cycle: {r['rounds']}")
        want(name, all(c[k1] == c[k2] == 0 for c in r["evals"]),
             "an FL eval launched the wire")
    return failures


def _reduced_card_vs_cpu(seed: int, card_name: str) -> tuple:
    """Phase 11 (b): CL, SL and FL (K1, K2) at the reduced config, 2
    cycles on the card and on the CPU; then one FL cycle's uploads from
    the card synced through K1 and K2 on both. Returns (summary,
    failures)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.draws import Key
    from repro_torch.nn import tree_leaves, tree_map
    from repro_torch.runtime import fl_runtime as FL
    from repro_torch.schemes import Experiment, build_scheme
    cfg = get_arch(QWEN).reduced()
    runs = _scaled_runs()
    summary, failures = {}, []
    for name in ("cl", "sl", "fl_k1", "fl_k2"):
        wcfg, opts, _ = runs[name]
        out = {}
        for dev in ("cuda", "cpu"):
            exp = Experiment(build_scheme(wcfg, cfg=cfg, device=dev, **opts),
                             cycles=2, seed=seed, n_train=128, n_test=32)
            out[dev] = (exp, exp.run())
        (ec, rc), (eh, rh) = out["cuda"], out["cpu"]
        bills = [(r.bits, r.n_tx, r.erased_bits) for r in ec.reports] == \
            [(r.bits, r.n_tx, r.erased_bits) for r in eh.reports] and \
            (ec.init_delivery is None) == (eh.init_delivery is None) and \
            (ec.init_delivery is None
             or ec.init_delivery.bits == eh.init_delivery.bits)
        dloss = max(abs(a - b) for a, b in zip(rc.loss, rh.loss))
        dacc = max(abs(a - b) for a, b in zip(rc.accuracy, rh.accuracy))
        summary[name] = dict(bills_equal=bills, loss_gap=dloss,
                             accuracy_gap=dacc, loss=rc.loss,
                             accuracy=rc.accuracy)
        print(f"reduced {name}: card vs CPU bills equal {bills}, loss gap "
              f"{dloss:.3e}, accuracy gap {dacc:.4f} ({card_name})",
              flush=True)
        if not bills or dloss > LOSS_TOL or dacc > ACC_TOL:
            failures.append(f"reduced {name} card vs CPU: {summary[name]}")
        if name == "fl_k1":
            state = ec.final_state
    key = Key(seed, 11)
    # uploads: one more local phase from the card's state (the delayed
    # step's new state is the unsynced local phase)
    wcfg = runs["fl_k1"][0]
    shape = build_scheme(wcfg, cfg=cfg, device="cpu").shape
    step = FL.make_fl_train_step(cfg, shape, wcfg, n_users=3,
                                 sync="delayed")
    rng = np.random.default_rng(seed + 12)
    x = rng.integers(1, cfg.vocab_size, (3, shape.global_batch,
                                         shape.seq_len)).astype(np.int32)
    b = {"tokens": torch.from_numpy(x).cuda(),
         "labels": torch.from_numpy(x).cuda()}
    carry, _ = step({"state": state.train, "agg":
                     state.train.trainable["model"]}, b, key, 3e-4)
    uploads = carry["state"].trainable["model"]
    for kern, use_kernel in (("K1", False), ("K2", True)):
        sync = FL.make_fl_sync(dataclasses.replace(
            wcfg, use_kernel=use_kernel), 3)
        on_card = sync(key, uploads, uploads)
        cpu_up = tree_map(lambda a: a.cpu(), uploads)
        on_cpu = sync(key, cpu_up, cpu_up)
        equal = all(torch.equal(a.cpu(), c) for a, c in
                    zip(tree_leaves(on_card), tree_leaves(on_cpu)))
        summary[f"sync_{kern}_equal"] = equal
        print(f"reduced FL sync through {kern} from the card's uploads, "
              f"redone on the CPU: equal {equal}", flush=True)
        if not equal:
            failures.append(f"reduced FL sync {kern}: card != CPU")
    return summary, failures


def _sync_inputs(gen, rows: int, bits: int = 8):
    """Packed-wire operands of `rows` rows made on the card from `gen`:
    per-row scaled normals, 32-bit words as int32 patterns, each row's
    amax scale and a p in [0, 0.1)."""
    import torch
    from repro_torch.core import quantization as Q
    buf = torch.randn((rows, 256), device="cuda", generator=gen)
    buf *= torch.rand((rows, 1), device="cuda", generator=gen) * 3 + 0.01
    words = torch.empty((rows, 256), dtype=torch.int32, device="cuda") \
        .random_(-2 ** 31, 2 ** 31 - 1, generator=gen)
    scale = Q.scale_from_amax(buf.abs().amax(1, keepdim=True), bits)
    p = torch.rand((rows, 1), device="cuda", generator=gen) * 0.1
    return buf, words, scale.contiguous(), p


def _events_ms(fn, reps: int = 3) -> float:
    """Mean device time of `fn()` over `reps` calls between two CUDA
    events (after one call to warm up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _slab_check(got, inputs, plain, rows: int) -> tuple:
    """`got` [rows, 256] against `plain(*inputs(a, b))`, the plain version
    on the operands of its rows a:b, slab by slab (the plain version's
    temporaries at the whole size would not fit). Returns (equal,
    max_abs_err, the plain slabs' summed device ms)."""
    import torch
    equal, err, ms = True, 0.0, 0.0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for a in range(0, rows, SYNC_SLAB_ROWS):
        b = min(rows, a + SYNC_SLAB_ROWS)
        args = inputs(a, b)
        e0.record()
        want = plain(*args)
        e1.record()
        e1.synchronize()
        ms += e0.elapsed_time(e1)
        equal = equal and bool(torch.equal(got[a:b], want))
        err = max(err, float((got[a:b] - want).abs().max()))
    return equal, err, ms


def _qwen_kernels(seed: int) -> tuple:
    """Phase 11 (c): K2 at one stacked [24, 1024, 1024] leaf of the qwen
    sync (3 users) and K1 at the full-width SL leg [1024, 256], each
    against its plain version bit for bit and timed beside its bound;
    then K1 and K2 at the whole FL sync (3 x 1,812,456 rows, the shape
    the path gives them), timed with events and held against their plain
    versions bit for bit slab by slab: the row geometry, K1's size_t
    element index and K2's u * rows + row at 5.4 M rows. Returns ({row
    name: {shape: times}}, {shape: times at the whole sync}, failures)."""
    import numpy as np
    import torch
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.kernels.quant_channel import ref as qref
    rng = np.random.default_rng(seed + 13)
    timed, failures = {}, []
    n, r = 3, QWEN_LEAF_ROWS
    buf, words, scale, p = wire_inputs(rng, n * r, 8)
    w = torch.full((n * r, 1), 1.0 / 3.0, device="cuda")
    got = qc.packed_wire_mean_2d(buf, words, scale, p, w, 8, n)
    want = qref.packed_wire_mean_ref(buf, words, scale, p, w, 8, n)
    equal = bool(torch.equal(got, want))
    print(f"  check packed_wire_mean_2d Q8 3 users [{n * r}, 256]: equal "
          f"{equal}", flush=True)
    if not equal:
        failures.append(f"K2 at [{n * r}, 256] differs from its plain version")
    del got, want
    timed["packed_wire_mean_2d"] = {(n * r, 256): _timed(
        lambda *a: qc.packed_wire_mean_2d(*a, 8, n),
        lambda *a: qref.packed_wire_mean_ref(*a, 8, n),
        (buf, words, scale, p, w),
        n * r * 256 * 8 + n * r * 12 + r * 256 * 4,
        n * r * 256 * wire_int_ops(8))}
    del buf, words, scale, p, w
    r = 1024
    buf, words, scale, p = wire_inputs(rng, r, 8)
    got = qc.packed_wire_2d(buf, words, scale, p, 8)
    equal = bool(torch.equal(got, qref.packed_wire_ref(buf, words, scale,
                                                       p, 8)))
    print(f"  check packed_wire_2d Q8 SL leg [1024, 256]: equal {equal}",
          flush=True)
    if not equal:
        failures.append("K1 at [1024, 256] differs from its plain version")
    timed["packed_wire_2d"] = {(r, 256): _timed(
        lambda *a: qc.packed_wire_2d(*a, 8),
        lambda *a: qref.packed_wire_ref(*a, 8), (buf, words, scale, p),
        r * 256 * 12 + r * 8, r * 256 * wire_int_ops(8))}
    del buf, words, scale, p
    # the whole FL sync: K1 over the 3 users' stacked rows, K2 to their
    # mean; its inputs are 11 GB, so one copy, events around 3 launches
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    rows = _fl_sync_rows(3)
    R = rows // 3
    whole = {}
    buf, words, scale, p = _sync_inputs(gen, rows)
    got = qc.packed_wire_2d(buf, words, scale, p, 8)
    ms = _events_ms(lambda: qc.packed_wire_2d(buf, words, scale, p, 8))
    equal, err, plain_ms = _slab_check(
        got, lambda a, b: (buf[a:b], words[a:b], scale[a:b], p[a:b]),
        lambda *a: qref.packed_wire_ref(*a, 8), rows)
    bms, by = bound_ms(rows * 256 * 12 + rows * 8, 0.0, torch.float32,
                       rows * 256 * wire_int_ops(8))
    whole["packed_wire_2d"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                   bound_by=by, library_ms=None,
                                   equal=equal, max_abs_err=err)
    del got
    w = torch.full((rows, 1), 1.0 / 3.0, device="cuda")

    def users(a, b):     # rows a:b of each user's block, stacked
        return tuple(torch.cat([t[u * R + a:u * R + b] for u in range(3)])
                     for t in (buf, words, scale, p, w))
    got = qc.packed_wire_mean_2d(buf, words, scale, p, w, 8, 3)
    ms = _events_ms(lambda: qc.packed_wire_mean_2d(buf, words, scale, p,
                                                   w, 8, 3))
    equal, err, plain_ms = _slab_check(
        got, users, lambda *a: qref.packed_wire_mean_ref(*a, 8, 3), R)
    bms, by = bound_ms(rows * 256 * 8 + rows * 12 + R * 256 * 4, 0.0,
                       torch.float32, rows * 256 * wire_int_ops(8))
    whole["packed_wire_mean_2d"] = dict(ms=ms, plain_ms=plain_ms,
                                        bound_ms=bms, bound_by=by,
                                        library_ms=None, equal=equal,
                                        max_abs_err=err)
    del buf, words, scale, p, w, got
    torch.cuda.empty_cache()
    for name, t in whole.items():
        print(f"  check {name} Q8 at the whole FL sync [{rows}, 256], "
              f"{SYNC_SLAB_ROWS} rows a slab: equal {t['equal']} "
              f"(max_abs_err {t['max_abs_err']:.3e})", flush=True)
        if not t["equal"]:
            failures.append(f"{name} at the whole FL sync [{rows}, 256] "
                            f"differs from its plain version")
        timed[name][(rows, 256)] = {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for name, t in timed.items():
        for shape, v in t.items():
            print(f"  time  {name} {list(shape)}: kernel {v['ms']:.5f} ms, "
                  f"plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.5f}"
                  f" ms ({v['bound_by']})", flush=True)
    return timed, {(rows, 256): whole}, failures


def scaled_phase(seed: int, card_name: str, shapes: dict) -> tuple:
    """Phase 11: the scaled schemes at full width (counters set to 0
    before, read after; K1's and K2's launches by shape into `shapes`),
    then card vs CPU at the reduced config and the kernel checks at the
    qwen shapes. Returns ({kernel name: launches}, summary, timed
    shapes, failures)."""
    counters = _all_counters()
    for f in counters.values():
        f.launches = 0
    runs, secs = {}, {}
    with launch_shapes({}) as phase_shapes:
        for name in _scaled_runs():
            t0 = time.perf_counter()
            runs[name] = _qwen_run(name, seed, card_name,
                                   profile_one=name in ("cl", "fl_k1"))
            secs[name] = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    failures = merge_shapes(shapes, phase_shapes, launches, "qwen")
    failures += _qwen_checks(runs)
    k1_shapes = dict(phase_shapes.get("packed_wire_2d", {}))
    sl, fl = runs["sl"], ("fl_k1", "fl_k2", "fl_delayed_int4")
    want_k1 = {(1024, 256): sum(c["packed_wire_2d"] for c in
                                sl["rounds"] + sl["evals"]),
               (_fl_sync_rows(3), 256): sum(
                   c["packed_wire_2d"] for n in fl
                   for c in runs[n]["rounds"] + runs[n]["profiled_rounds"])}
    print(f"qwen launches {launches}; K1 by shape {k1_shapes} (want "
          f"{want_k1})", flush=True)
    if k1_shapes != want_k1:
        failures.append(f"qwen: K1 by shape {k1_shapes}, want {want_k1}")
    t0 = time.perf_counter()
    reduced, f = _reduced_card_vs_cpu(seed, card_name)
    failures += f
    secs["reduced_card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed, sync_time, f = _qwen_kernels(seed)
    failures += f
    secs["kernels"] = time.perf_counter() - t0
    print(f"qwen phase parts: "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}",
          flush=True)
    summary = dict(runs=runs, reduced=reduced, seconds=secs,
                   k1_by_shape={str(list(k)): v
                                for k, v in k1_shapes.items()},
                   whole_sync={str(list(k)): v
                               for k, v in sync_time.items()})
    return launches, summary, timed, failures


# ------------------------- the MoE family and the wide dense configs (P15)
# phase 12. (a)-(c) serve, paged then dense, at full width with random
# weights from --seed: qwen3-moe-235b-a22b (d_model 4096, 64 / 4 heads, hd
# 64, 128 experts top-8, expert d_ff 1536, vocab 151,936) at 4 of its 94
# layers and llama4-scout-17b-a16e (d_model 5120, 40 / 8 heads, hd 128,
# 16 experts top-1 + a shared expert, expert d_ff 8192, vocab 202,048)
# at 2 of 48; chatglm3-6b (28 layers, hd 128, 32 / 2 heads, half-dim
# RoPE, QKV bias) at full depth and command-r-plus-104b (d_model 12,288,
# 96 / 8 heads, hd 128, layernorm, parallel block) at 2 of 64. Depth is
# cut with dataclasses.replace here, not by a flag. Each run: K8 + K10
# (paged) or K7 + K9 (dense) once per layer per decode step and prefill
# chunk; paged = dense in bills, tokens and first-chunk logits, bit for
# bit; first-chunk logits finite and within 8 bf16 ulps at the run's
# largest |logit| of a plain reference. For the dense family that is the
# teacher-forced `forward`. For MoE it is the port's fused `prefill_step`
# with the plain attention on the same [B, C] chunk and cache: capacity
# makes the output depend on which tokens share a call, so `forward`
# (other groupings) is no reference. The reference computes its own
# float32 routing; where its top-k set differs from the kernel run's it
# takes the kernel run's experts, and such a swap is accepted only where
# the two lie within ROUTER_TIE router logits (a near-tie that a bf16 ulp
# of the router's input can flip). (d) qwen3-moe-235b-a22b and
# llama4-scout-17b-a16e at `reduced()` through the scaled CL, SL and FL
# (K1 sync) schemes, one cycle each on the card and on the CPU: bills
# equal, losses within LOSS_TOL, accuracy within ACC_TOL, the load-balance
# loss of every CL / SL step finite and > 0, K1 at the SL legs and the FL
# sync by shape, no K3-K10 launch.
MOE_TRACE = dict(prompt_lens=(32, 128), new_tokens=(8, 32))
# (arch, layers served (0: all), requests, first-chunk reference)
SERVED = (("qwen3-moe-235b-a22b", 4, 16, "prefill"),
          ("llama4-scout-17b-a16e", 2, 8, "prefill"),
          ("chatglm3-6b", 0, 8, "forward"),
          ("command-r-plus-104b", 2, 8, "forward"),
          ("stablelm-12b", 0, 8, "forward"),
          ("internvl2-76b", 4, 8, "forward"))
ROUTER_TIE = 2 ** -5
MOE_TRAINED = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")


def ulp_tol(x, ulps: int = 8) -> float:
    """`ulps` bf16 ulps at the largest |x| (bf16 keeps 8 significant
    bits)."""
    return ulps * 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)


class RouteTape:
    """Swaps `repro_torch.models.moe.route` while recording the expert
    ids of every MoE call in order, or while replaying a recording: a
    replaying call computes its own float32 routing and, where its top-k
    set differs from the recorded one, takes the recorded experts with
    gates from its own probabilities; `margins` logs, per such token,
    how many router logits the recorded set's weakest expert lies below
    the replaying call's own k-th choice."""

    def __init__(self):
        self.margins = []

    @contextlib.contextmanager
    def _swapped(self, fn):
        from repro_torch.models import moe
        kept = moe.route
        moe.route = fn(kept)
        try:
            yield
        finally:
            moe.route = kept

    @contextlib.contextmanager
    def record(self):
        log = []

        def wrap(orig):
            def route(p, xf, cfg):
                out = orig(p, xf, cfg)
                log.append(out[2])
                return out
            return route
        with self._swapped(wrap):
            yield log

    @contextlib.contextmanager
    def replay(self, routes):
        import torch
        from repro_torch.models.layers import linear
        it = iter(routes)

        def wrap(orig):
            def route(p, xf, cfg):
                probs, gate, idx = orig(p, xf, cfg)
                want = next(it)
                diff = (idx.sort(-1).values != want.sort(-1).values).any(-1)
                if not bool(diff.any()):
                    return probs, gate, idx
                z = linear(p["router"], xf.float())[diff]
                own = z.gather(1, idx[diff]).min(-1).values
                self.margins += (own - z.gather(1, want[diff]).min(-1)
                                 .values).tolist()
                gate = probs.gather(1, want)
                gate = gate / torch.clamp(gate.sum(-1, keepdim=True),
                                          min=1e-9)
                return probs, gate, want
            return route
        with self._swapped(wrap):
            yield


@contextlib.contextmanager
def plain_attention():
    """While open, the model's attention calls run the kernels' plain
    versions on the card (the reference runs; no counter moves)."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.prefill_attention import ops as pre
    from repro_torch.kernels.prefill_attention import ref as pref
    plain = {(dec, "gqa_decode"): dref.decode_attention_ref,
             (dec, "gqa_decode_paged"): dref.paged_decode_attention_ref,
             (pre, "gqa_prefill"): pref.prefill_attention_ref,
             (pre, "gqa_prefill_paged"): pref.paged_prefill_attention_ref}
    kept = {k: getattr(*k) for k in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, lambda *a, _f=fn, **kw: _f(*a, **kw).float())
    try:
        yield
    finally:
        for (mod, name), fn in kept.items():
            setattr(mod, name, fn)


@contextlib.contextmanager
def drop_log(log: list):
    """While open, every MoE layer call of the transformer appends
    ("prefill" or "decode", its dropped fraction tensor) to `log`."""
    from repro_torch.models import transformer as T
    kept = T.apply_moe

    def spy(p, h, cfg):
        y, aux = kept(p, h, cfg)
        log.append(("decode" if h.shape[1] == 1 else "prefill",
                    aux["dropped_frac"].detach()))
        return y, aux
    T.apply_moe = spy
    try:
        yield log
    finally:
        T.apply_moe = kept


def busy_split(prof: dict, kv: str) -> dict:
    """The traced device busy time split by what ran: the expert products
    (aten::bmm), casts and copies (aten::copy_: the per-call f32 -> bf16
    weight casts and the KV writes), and the layout's attention kernels."""
    busy = prof.get("device_busy_s")
    ops = prof.get("device_us_by_op", {})
    if not busy:
        return {"note": "not measured"}
    out = {"expert_products_s": ops.get("aten::bmm", 0.0) / 1e6,
           "casts_and_copies_s": ops.get("aten::copy_", 0.0) / 1e6,
           "attention_s": busy * sum(prof.get(f"{k}_share_of_busy", 0.0)
                                     for k in SERVE_PATH[kv])}
    out.update({k.replace("_s", "_share"): v / busy for k, v in
                list(out.items())})
    return out


def serve_model(name: str, depth: int, n_req: int, ref: str,
                seed: int) -> tuple:
    """Phase 12 (a)-(c) for one config. Returns ({kernel: launches},
    {kernel shape: launches}, summary, failures)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import api as M
    from repro_torch.models import transformer as T
    from repro_torch.nn import count_params, init_params
    from repro_torch.serve import make_trace
    cfg = get_arch(name)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    params = init_params(M.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(seed), "cuda")
    trace = make_trace(seed, n_req, **MOE_TRACE)
    init_s = time.perf_counter() - t0
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}"
          f", {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, experts {cfg.n_experts} top-{cfg.top_k}"
          f"{' + shared' if cfg.shared_expert else ''}, vocab "
          f"{cfg.vocab_size}, {count_params(params)} params, {cfg.dtype}; "
          f"init {init_s:.2f} s", flush=True)
    failures, runs, launches, drops = [], {}, {}, {}
    secs = {"init": init_s}
    for kv in ("paged", "dense"):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        with drop_log([]) as dl:
            eng, rep, firsts, calls, n, kept, warm = serve_once(
                cfg, params, trace, kv, keep_chunks=ref == "prefill"
                and kv == "paged")
        d = rep.to_dict()
        d["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() \
            / 2 ** 30
        print_serve(f"{cfg.name} kv={kv}", warm, calls, d, n)
        print(f"  max_memory_allocated "
              f"{d['max_memory_allocated_gib']:.2f} GiB", flush=True)
        failures += launch_failures(cfg, kv, calls, n)
        launches.update({k: n[k] for k in SERVE_PATH[kv]})
        if cfg.is_moe:     # the serve's own calls: warmup's come first
            served = dl[-cfg.n_layers * (calls["decode"]
                                         + calls["prefill"]):]
            drops[kv] = {k: float(torch.stack(
                [t for kk, t in served if kk == k]).mean())
                for k in ("prefill", "decode")}
            print(f"  mean dropped fraction: prefill chunks "
                  f"{drops[kv]['prefill']:.4f}, decode steps "
                  f"{drops[kv]['decode']:.4f}", flush=True)
            if drops[kv]["decode"] != 0.0:
                failures.append(f"{cfg.name}: a decode step dropped")
        runs[kv] = (eng, rep, firsts, d, kept)
        secs[kv] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = profile_phase(runs["paged"][0], traced_sample(trace), "paged")
    secs["profile"] = time.perf_counter() - t0
    split = busy_split(prof, "paged")
    print(f"  traced busy split (paged, {PROFILED} requests of at most "
          f"{PROFILED_TOKENS} new tokens): {split}", flush=True)
    if prof.get("unmatched_kernel_patterns"):
        failures.append(f"{cfg.name}: no traced kernel matches "
                        f"{prof['unmatched_kernel_patterns']}")
    (_, rp, fp, dp, kept), (_, rd, fd, dd, _) = runs["paged"], runs["dense"]
    same_tokens, f = layouts_agree(rp, rd)
    failures += [f"{cfg.name}: {x}" for x in f]
    # first-chunk logits: finite, paged == dense, near the reference
    refs, tape, pf = [], RouteTape(), None
    t0 = time.perf_counter()
    with torch.inference_mode():
        if ref == "prefill":
            pf = runs["paged"][0].build(max(8, trace.max_seq_len()))[
                "prefill"]
            for snap, toks, st, nv, tbl, routes, rows in kept:
                with tape.replay(routes), plain_attention():
                    lg, _ = pf(snap, toks, st, nv, tbl)
                refs += [lg[b] for b in rows]
        else:
            refs = [T.forward(params, {"tokens": tp[None]}, cfg)[0][0, -1]
                    .float() for tp, _ in fp]
    secs["reference"] = time.perf_counter() - t0
    print(f"  seconds: {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}",
          flush=True)
    if len(fp) != len(fd) or len(refs) != len(fp) or not fp:
        failures.append(f"{cfg.name} first chunks: {len(fp)} paged, "
                        f"{len(fd)} dense, {len(refs)} references")
    equal, worst, tol = True, 0.0, 0.0
    for (tp, lp), (td, ld), rf in zip(fp, fd, refs):
        equal = equal and torch.equal(tp, td) and torch.equal(lp, ld)
        if not (torch.isfinite(lp).all() and lp.shape == rf.shape):
            failures.append(f"{cfg.name}: first-chunk logits not finite")
        tol = max(tol, ulp_tol(rf))
        worst = max(worst, float((lp - rf).abs().max()))
    margin = max(tape.margins, default=0.0)
    print(f"  first-chunk logits over {len(fp)} requests: paged == dense "
          f"bit for bit {equal}; max |paged - {ref} reference| "
          f"{worst:.4e} (tol {tol:g}, 8 bf16 ulps at the largest |logit|)"
          + (f"; routing swaps in the reference {len(tape.margins)}, "
             f"largest margin {margin:.4e} router logits (tie bound "
             f"{ROUTER_TIE:g})" if ref == "prefill" else ""), flush=True)
    if not equal:
        failures.append(f"{cfg.name}: paged and dense first chunks differ")
    if worst > tol:
        failures.append(f"{cfg.name}: first-chunk logits differ from the "
                        f"{ref} reference by {worst} > {tol}")
    if margin > ROUTER_TIE:
        failures.append(f"{cfg.name}: the reference picks other experts "
                        f"by up to {margin} router logits")
    summary = dict(paged=dp, dense=dd, layers=cfg.n_layers,
                   equal_token_requests=same_tokens, first_chunks=len(fp),
                   first_chunk_max_abs_vs_reference=worst,
                   logit_tol=tol, reference=ref,
                   routing_swaps=len(tape.margins), routing_margin=margin,
                   dropped_frac=drops, profile_paged=prof,
                   busy_split=split, seconds=secs)
    shape = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd)
    # an engine and its step closures refer to each other: only the
    # collector frees them, and with them the weights
    del runs, params, eng, kept, refs, pf
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {shape: dict(launches)}, summary, failures


def reduced_training(seed: int, card_name: str, shapes: dict,
                     names=MOE_TRAINED, what: str = "moe training",
                     steps: int = 0) -> tuple:
    """Phase 12 (d) and 13 (d): `names` at `reduced()` through the scaled
    CL, SL and FL (K1) schemes, one cycle each on the card and the CPU
    (`steps` > 0: that many CL / SL steps a cycle and FL local steps
    instead of phase 11's).
    Returns ({kernel: launches}, summary, failures)."""
    import dataclasses
    import math as _m
    from repro_torch.configs import get_arch
    from repro_torch.schemes import Experiment, build_scheme
    counters = _all_counters()
    for f in counters.values():
        f.launches = 0
    summary, failures = {}, []
    with launch_shapes({}) as phase_shapes:
        for name in names:
            cfg = get_arch(name).reduced()
            for mode in ("cl", "sl", "fl_k1"):
                wcfg, opts, _ = _scaled_runs()[mode]
                if steps and opts:
                    opts = dict(opts, steps_per_cycle=steps)
                elif steps:
                    wcfg = dataclasses.replace(wcfg, local_steps=steps)
                out = {}
                for dev in ("cuda", "cpu"):
                    scheme = build_scheme(wcfg, cfg=cfg, device=dev, **opts)
                    aux = []
                    if hasattr(scheme, "_step"):
                        step = scheme._step

                        def logged(*a, _s=step, _l=aux, **kw):
                            st, m = _s(*a, **kw)
                            if not m["aux_loss"].is_meta:
                                _l.append(float(m["aux_loss"]))
                            return st, m
                        scheme._step = logged
                    n0 = {k: f.launches for k, f in counters.items()}
                    exp = Experiment(scheme, cycles=1, seed=seed,
                                     n_train=128, n_test=32)
                    out[dev] = (exp, exp.run(), aux, {
                        k: f.launches - n0[k] for k, f in counters.items()})
                (ec, rc, ac, nc), (eh, rh, ah, _) = out["cuda"], out["cpu"]
                bills = [(r.bits, r.n_tx, r.erased_bits) for r in
                         ec.reports] == [(r.bits, r.n_tx, r.erased_bits)
                                         for r in eh.reports]
                dloss = max(abs(a - b) for a, b in zip(rc.loss, rh.loss))
                dacc = max(abs(a - b) for a, b in
                           zip(rc.accuracy, rh.accuracy))
                lb_ok = mode == "fl_k1" or not cfg.is_moe or (
                    ac and ah and all(_m.isfinite(x) and x > 0
                                      for x in ac + ah))
                other = {k: v for k, v in nc.items()
                         if k not in _wire_counters() and v}
                k1 = nc["packed_wire_2d"] + nc["packed_wire_mean_2d"]
                rec = dict(bills=[r.bits for r in ec.reports],
                           bills_equal=bills, loss=rc.loss,
                           loss_gap=dloss, accuracy_gap=dacc,
                           lb_loss=ac, launches=nc)
                summary[f"{name} {mode}"] = rec
                print(f"reduced {name} {mode}: card vs CPU bills equal "
                      f"{bills} ({rec['bills']}), loss {rc.loss} gap "
                      f"{dloss:.3e}, accuracy gap {dacc:.4f}, lb_loss "
                      f"{[round(x, 4) for x in ac]}, launches "
                      f"{ {k: v for k, v in nc.items() if v} } "
                      f"({card_name})", flush=True)
                if not bills or dloss > LOSS_TOL or dacc > ACC_TOL \
                        or not lb_ok or other or (mode != "cl" and k1 == 0):
                    failures.append(f"reduced {name} {mode}: {rec}")
    launches = {k: f.launches for k, f in counters.items()}
    failures += merge_shapes(shapes, phase_shapes, launches, what)
    summary["k1_by_shape"] = {str(list(k)): v for k, v in
                              phase_shapes.get("packed_wire_2d", {}).items()}
    print(f"{what} K1 by shape {summary['k1_by_shape']}", flush=True)
    return launches, summary, failures


def wide_phase(seed: int, card_name: str, shapes: dict) -> tuple:
    """Phase 12. Returns ({kernel: launches}, {kernel: {(Hkv, G, hd):
    launches}}, summary, failures)."""
    launches, by_shape, summary, failures, secs = {}, {}, {}, [], {}
    for name, depth, n_req, ref in SERVED:
        t0 = time.perf_counter()
        n, per_shape, summary[name], f = serve_model(name, depth, n_req,
                                                     ref, seed)
        secs[name] = time.perf_counter() - t0
        failures += f
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        for shp, counts in per_shape.items():
            for k, v in counts.items():
                by_shape.setdefault(k, {})[shp] = \
                    by_shape.get(k, {}).get(shp, 0) + v
    t0 = time.perf_counter()
    train_launches, summary["training"], f = reduced_training(
        seed, card_name, shapes)
    secs["training"] = time.perf_counter() - t0
    failures += f
    for k, v in train_launches.items():
        launches[k] = launches.get(k, 0) + v
    summary["seconds"] = secs
    print(f"phase 12 parts: "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}",
          flush=True)
    return launches, by_shape, summary, failures


# ------------------------- phases 13 and 14: the recurrent and enc-dec
XLSTM = "xlstm-350m"
HYBRID, AUDIO = "zamba2-1.2b", "seamless-m4t-medium"
# the static serving loop's batch: 4 users, 32 prompt and 16 new tokens
STATIC_SERVE = dict(batch=4, prompt_len=32, new_tokens=16)
# K7 launches a decode step of the static loop: none for xLSTM (no
# attention), the shared block's 6 applications for zamba2-1.2b, 12
# self- and 12 cross-attention layers for seamless-m4t-medium
STATIC_K7 = {XLSTM: 0, HYBRID: 6, AUDIO: 24}
# the static loop's prompt logits against the teacher-forced forward, in
# bf16 ulps at the largest |logit|: 8 as phase 12; zamba2-1.2b's 16 from
# its measured gap (15.75 ulps, 0.4922 at |logit| < 4, H100 80GB HBM3 at
# 700 W), which grows block by block through its 38 Mamba2 blocks (the
# gaps `hybrid_layer_gaps` prints: 0.5 ulps after the first block, at
# most 19.5, 12.2 after the last): the decode's recurrent SSD and its
# 4-row GEMMs round in other places than the forward's chunked scan and
# 128-row GEMMs, and the SSM state carries each difference on to the
# later tokens
STATIC_ULPS = {XLSTM: 8, HYBRID: 16, AUDIO: 8}
# the cuts of the full-width runs, all of steps: 2 steps a CL / SL cycle
# (the loss must fall from the first to the second), 1 local step a user
# in FL, and 4 eval slices (32 held-out rows); the corpus, batch and
# sequence are the training CLI's (512 training rows, batch 8, seq 128)
FAMILY_STEPS, FAMILY_FL_STEPS, FAMILY_N_TEST = 2, 1, 32
# (CL's corpus bits once: token_bits(vocab) x 512 x 128; SL's bits a
# step: 2 legs x 8 bits x crossing_elems) at full width
FAMILY_BILLS = {
    XLSTM: (512 * 128 * 16, 4_194_304),     # vocab 50,304; 8 x 128 x 256
    HYBRID: (512 * 128 * 15, 8_388_608),    # vocab 32,000; 8 x 128 x 512
    AUDIO: (512 * 128 * 18, 16_777_216),    # vocab 256,256; 8 x 512 x 256
}
# the FL run goes through the training CLI, as a user types it
FAMILY_FL_CLI = ["--mode", "fl", "--steps", str(FAMILY_FL_STEPS),
                 "--local-steps", str(FAMILY_FL_STEPS), "--n-test",
                 str(FAMILY_N_TEST)]
REDUCED_TRAINED = ("internvl2-76b", "xlstm-350m")


@contextlib.contextmanager
def _hybrid_taps(log: list):
    """While open, every Mamba2 block and every shared block of the
    hybrid, in `forward` and in `decode_step`, appends its output (f32)
    to `log`."""
    from repro_torch.models import hybrid as Hy
    names = ("apply_mamba_block", "_shared_block", "apply_mamba_decode",
             "_shared_decode")
    kept = {n: getattr(Hy, n) for n in names}

    def tap(fn, first):
        def call(*a, **kw):
            out = fn(*a, **kw)
            log.append((out[0] if first else out).float())
            return out
        return call
    for n in names:
        setattr(Hy, n, tap(kept[n], n == "apply_mamba_decode"))
    try:
        yield log
    finally:
        for n, fn in kept.items():
            setattr(Hy, n, fn)


def hybrid_layer_gaps(cfg, params, tokens) -> list:
    """The token-by-token decode's gap to the teacher-forced forward
    after each block of the hybrid, in the order the blocks run (6 x (6
    Mamba2 + the shared block) + 2 tail blocks), in bf16 ulps at that
    output's largest |x|."""
    import torch
    from repro_torch.models import hybrid as Hy
    B, P = tokens.shape
    with torch.inference_mode():
        with _hybrid_taps([]) as fw:
            Hy.forward(params, {"tokens": tokens}, cfg)
        cache = Hy.init_cache(cfg, B, P, "cuda")
        with _hybrid_taps([]) as dec:
            for i in range(P):
                Hy.decode_step(params, cache, tokens[:, i:i + 1], i, cfg)
    n = len(fw)
    return [float((torch.cat(dec[l::n], 1) - ref).abs().max())
            / ulp_tol(ref, 1) for l, ref in enumerate(fw)]


def static_serve(name: str, seed: int, card_name: str) -> tuple:
    """Phases 13 and 14, serving: `launch.serve --arch name` at full
    width (the static loop), every kernel counter set to 0 before and
    read after. Returns (summary, {(B, Hkv, G, hd): K7 launches},
    failures)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.centralized import token_bits
    from repro_torch.launch import serve
    from repro_torch.models import api as M
    from repro_torch.models.encdec import src_len
    from repro_torch.nn import count_params, init_tree
    argv = ["--arch", name, "--seed", str(seed), "--snr-db", "10",
            "--greedy"] + [x for k, v in STATIC_SERVE.items()
                           for x in (f"--{k.replace('_', '-')}", str(v))]
    B, P, N = (STATIC_SERVE[k] for k in ("batch", "prompt_len",
                                          "new_tokens"))
    cfg = get_arch(name)
    counters = _all_counters()
    for f in counters.values():
        f.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve.main(argv)
    wall = time.perf_counter() - t0
    n = {k: f.launches for k, f in counters.items() if f.launches}
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    # the reference: the same weights (the loop's seeded card generator)
    # through the teacher-forced forward, on the prompt the server got
    # (and the loop's stub frames), its bf16 products reducing in f32 as
    # the JAX package's dots do: cuBLAS's default lets a split-K bf16 GEMM
    # of the forward's 128 rows reduce in bf16, which moves its logits
    # (the gap is printed)
    params = init_tree(M.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(seed), "cuda")
    batch = {"tokens": torch.from_numpy(out["prompt"]).cuda()}
    if cfg.family == "audio":
        batch["frames"] = 0.1 * torch.ones(
            (B, src_len(cfg, P + N), cfg.d_model), device="cuda")
    forward = M.get_model(cfg).forward
    mm = torch.backends.cuda.matmul
    with torch.inference_mode():
        loose = forward(params, batch, cfg)[0].float()
        kept = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            ref, _ = forward(params, batch, cfg)
        finally:
            mm.allow_bf16_reduced_precision_reduction = kept
    ref, got = ref.float(), out["prompt_logits"]
    tol = ulp_tol(ref, STATIC_ULPS[name])
    worst = float((got - ref).abs().max())
    worst_loose = float((got - loose).abs().max())
    gaps = (hybrid_layer_gaps(cfg, params, batch["tokens"])
            if cfg.family == "hybrid" else [])
    for k, f in counters.items():     # the gaps' own decode is not served
        f.launches = n.get(k, 0)
    up, down = (float(token_bits(cfg.vocab_size) * B * t) for t in (P, N))
    want_bits = up + down
    radio = serve.make_radio(serve.parse_args(argv))
    want_k7 = STATIC_K7[name] * (P + N)
    shape = (B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd)
    summary = dict(params=count_params(params),
                   prompt_s=out["t_prefill_s"], decode_s=out["t_decode_s"],
                   tokens_per_s=B * N / out["t_decode_s"], wall_s=wall,
                   bits=out["bits"], erased_bits=out["erased_bits"],
                   energy_j=out["energy_j"], max_memory_gib=mem,
                   prompt_logits_max_abs_vs_forward=worst, logit_tol=tol,
                   vs_forward_with_bf16_reductions=worst_loose,
                   layer_gaps_ulps=gaps, launches=n)
    print(f"serve {name} (static loop, {summary['params']} params, {B} x "
          f"{P} prompt + {N} new tokens): prompt {out['t_prefill_s']:.3f} "
          f"s, decode {out['t_decode_s']:.3f} s = "
          f"{summary['tokens_per_s']:.1f} tok/s; bits {out['bits']:.0f} "
          f"(want {want_bits:.0f}), erased {out['erased_bits']:.0f}, "
          f"energy {out['energy_j']:.6e} J; prompt logits vs forward max "
          f"|diff| {worst:.4e} = {worst / ulp_tol(ref, 1):.2f} ulps (tol "
          f"{tol:g}, {STATIC_ULPS[name]} bf16 ulps at the largest |logit|; "
          f"{worst_loose:.4e} against the forward with cuBLAS's "
          f"bf16 split-K reductions); max_memory_allocated {mem:.2f} GiB; "
          f"launches {n} (K7 want {want_k7}, {STATIC_K7[name]} a step, "
          f"heads {shape[1:]}) ({card_name})", flush=True)
    if gaps:
        print(f"  {name} decode vs forward after each block, bf16 ulps at "
              f"its largest |x|: {[round(g, 2) for g in gaps]}", flush=True)
    failures = []
    if not (torch.isfinite(got).all() and got.shape == ref.shape) \
            or worst > tol:
        failures.append(f"{name} serving: prompt logits {worst} > {tol}")
    if out["bits"] != want_bits or out["erased_bits"] != 0.0 \
            or out["generated"].shape != (B, N) \
            or out["energy_j"] != radio.energy_j(up) + radio.energy_j(down):
        failures.append(f"{name} serving: the bill does not add up "
                        f"{summary}")
    if n != ({"decode_attention": want_k7} if want_k7 else {}):
        failures.append(f"{name} serving launched {n}, want K7 {want_k7}")
    del params, ref, got, out, loose, batch
    torch.cuda.empty_cache()
    return summary, ({shape: want_k7} if want_k7 else {}), failures


def _family_run(name: str, mode: str, seed: int, card_name: str) -> dict:
    """One full-width cycle of `name` on the card: CL / SL through
    `build_scheme` + `Experiment` (AdamW, FAMILY_STEPS steps; SL cut at
    layer / super-block 2, or the encoder output), FL through the
    training CLI (3 users x FAMILY_FL_STEPS local steps, Q8, K1 sync).
    Returns its record."""
    import torch
    from repro_torch.configs import WirelessConfig, get_arch
    from repro_torch.schemes import Experiment, build_scheme
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kinds, losses, clock = [], [], {}
    t0 = time.perf_counter()
    if mode == "fl":
        from repro_torch.launch import train
        kept = train.build_scheme

        def counted_scheme(*a, **kw):
            sch = kept(*a, **kw)
            _counted(sch, kinds)
            return sch
        train.build_scheme = counted_scheme
        try:
            with _sync_clock(clock):
                out = train.main(["--arch", name, "--seed", str(seed)]
                                 + FAMILY_FL_CLI)
        finally:
            train.build_scheme = kept
        exp, res = out["experiment"], out["result"]
        del out
    else:
        wcfg = (WirelessConfig(mode="cl", snr_db=20.0) if mode == "cl" else
                WirelessConfig(mode="sl", quant_bits=8, snr_db=20.0,
                               split_layer=2, compress_factor=4))
        scheme = build_scheme(wcfg, cfg=get_arch(name), device="cuda",
                              optimizer="adamw",
                              steps_per_cycle=FAMILY_STEPS)
        _counted(scheme, kinds, losses)
        exp = Experiment(scheme, cycles=1, seed=seed,
                         n_train=SCALED_N_TRAIN, n_test=FAMILY_N_TEST)
        with _sync_clock(clock):
            res = exp.run()
    wall = time.perf_counter() - t0
    main, step_losses = list(kinds), list(losses)
    prof = _profile_eval(exp, seed, name) if mode == "cl" else None
    rec = dict(bits=[r.bits for r in exp.reports],
               n_tx=[r.n_tx for r in exp.reports], loss=res.loss,
               accuracy=res.accuracy, step_losses=step_losses,
               init_bits=(exp.init_delivery.bits if exp.init_delivery
                          else None),
               round_s=[s for k, _, s in main if k == "round"],
               eval_s=[s for k, _, s in main if k == "eval"],
               rounds=[c for k, c, _ in main if k == "round"],
               evals=[c for k, c, _ in main if k == "eval"],
               wall_s=wall, max_memory_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30, peak_rss_gib=_peak_rss_gib(), **clock)
    if prof is not None:
        rec["profile"] = prof
    del exp
    torch.cuda.empty_cache()
    print(f"{name} {mode}: 1 cycle, {wall:.1f} s (round "
          f"{[round(x, 3) for x in rec['round_s']]} s, eval "
          f"{[round(x, 3) for x in rec['eval_s']]} s); sync "
          f"{rec.get('sync_s', 0.0):.2f} s of which flip-word draws "
          f"{rec.get('words_host_s', 0.0):.2f} s on the host; "
          f"max_memory_allocated {rec['max_memory_gib']:.2f} GiB; peak RSS "
          f"{rec['peak_rss_gib']:.2f} GiB; bits {rec['bits']}; n_tx "
          f"{rec['n_tx']}; init {rec['init_bits']}; loss {res.loss} (steps "
          f"{[round(x, 4) for x in step_losses]}); accuracy "
          f"{res.accuracy} ({card_name})", flush=True)
    return rec


def _profile_eval(exp, seed: int, name: str) -> dict:
    """One eval slice (8 held-out rows: the forward of the trained model)
    under torch.profiler, device activity only: the device's idle share.
    A training step launches ~4x its kernels, and the profiler's own
    processing grows with them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _, (xte, yte) = exp.scheme.default_data(8, 8, seed + 11)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.scheme.evaluate(exp.final_state, xte, yte)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _idle_summary(prof, wall_us, f"{name}, one eval slice")


def _family_checks(name: str, runs: dict) -> list:
    """The gates on the full-width runs of phases 13 and 14: exact
    bills, finite losses, CL's and SL's loss falling, K1 twice an SL
    step, once an SL eval slice and once an FL cycle, no K3-K10."""
    import math
    from repro_torch.configs import get_arch
    from repro_torch.models import api as M
    from repro_torch.nn import count_params, tree_leaves
    specs = M.train_param_specs(get_arch(name))
    cl_bits, sl_step_bits = FAMILY_BILLS[name]
    failures = []
    k1, k2 = "packed_wire_2d", "packed_wire_mean_2d"

    def want(mode, ok, what):
        if not ok:
            failures.append(f"{name} {mode}: {what}")
    for mode, r in runs.items():
        want(mode, all(math.isfinite(x) for x in r["loss"]
                       + r["step_losses"]), f"a loss is not finite "
             f"{r['loss']}")
        for c in r["rounds"] + r["evals"]:
            want(mode, not any(c[k] for k in ("conv_pool",
                                              "lstm_final_state",
                                              "quant_channel_2d",
                                              "packed_wire_2d_philox")
                               + ATTN_ROWS), f"K3-K10 launched: {c}")
    cl, sl = runs["cl"], runs["sl"]
    want("cl", cl["init_bits"] == cl_bits, f"init bits {cl['init_bits']}")
    want("cl", all(c[k1] == c[k2] == 0 for c in cl["rounds"] + cl["evals"]),
         "CL launched the wire")
    want("sl", sl["bits"] == [FAMILY_STEPS * sl_step_bits]
         and sl["n_tx"] == [2.0 * FAMILY_STEPS], f"bill {sl['bits']}, "
         f"n_tx {sl['n_tx']}")
    want("sl", all(c[k1] == 2 * FAMILY_STEPS and c[k2] == 0
                   for c in sl["rounds"]), "K1 not twice a step")
    want("sl", all(c[k1] == FAMILY_N_TEST // 8 for c in sl["evals"]),
         "K1 not once an eval slice")
    for mode in ("cl", "sl"):
        r = runs[mode]
        want(mode, len(r["step_losses"]) == FAMILY_STEPS
             and r["step_losses"][-1] < r["step_losses"][0],
             f"loss did not fall {r['step_losses']}")
    if "fl" in runs:
        fl, n_leaves = runs["fl"], len(tree_leaves(specs))
        per_user = [b / 3 for b in fl["bits"]]
        want("fl", per_user == [8.0 * count_params(specs)],
             f"bits per user {per_user}")
        want("fl", fl["n_tx"] == [3.0 * n_leaves], f"n_tx {fl['n_tx']} "
             f"(3 users x {n_leaves} leaves)")
        want("fl", all(c[k1] == 1 and c[k2] == 0 for c in fl["rounds"]),
             f"K1 not once a cycle: {fl['rounds']}")
        want("fl", all(c[k1] == c[k2] == 0 for c in fl["evals"]),
             "an FL eval launched the wire")
    return failures


def family_phase(seed: int, card_name: str, shapes: dict, served: tuple,
                 modes: tuple, reduced: tuple, phase: int) -> tuple:
    """Phases 13 and 14: each of `served` through the static serving
    loop and its `modes` at full width, then `reduced` at `reduced()`
    through the scaled CL, SL and FL (K1) schemes, card vs CPU. Returns
    ({kernel: launches}, {kernel: {(B, Hkv, G, hd): launches}}, summary,
    failures)."""
    secs, summary, failures, by_shape = {}, {}, [], {}
    counters = _all_counters()
    for f in counters.values():
        f.launches = 0
    launches = dict.fromkeys(counters, 0)

    def tally():
        """Move the counts into `launches`: every part (a serve, a run)
        starts from 0."""
        for k, f in counters.items():
            launches[k] += f.launches
            f.launches = 0
    with launch_shapes({}) as phase_shapes:
        for name in served:
            t0 = time.perf_counter()
            summary[name], k7, f = static_serve(name, seed, card_name)
            tally()
            secs[f"{name} serve"] = time.perf_counter() - t0
            failures += f
            for shp, v in k7.items():
                by_shape.setdefault("decode_attention", {})[shp] = v
            runs = {}
            for mode in modes:
                t0 = time.perf_counter()
                runs[mode] = _family_run(name, mode, seed, card_name)
                tally()
                secs[f"{name} {mode}"] = time.perf_counter() - t0
            failures += _family_checks(name, runs)
            summary[name]["training"] = runs
    failures += merge_shapes(shapes, phase_shapes, launches,
                             f"phase {phase} full width")
    summary["k1_by_shape"] = {str(list(k)): v for k, v in
                              phase_shapes.get("packed_wire_2d", {}).items()}
    print(f"phase {phase} full width: launches {launches}; K1 by shape "
          f"{summary['k1_by_shape']}", flush=True)
    t0 = time.perf_counter()
    red_launches, summary["reduced"], f = reduced_training(
        seed, card_name, shapes, reduced, f"phase {phase} reduced training",
        FAMILY_STEPS)
    secs["reduced"] = time.perf_counter() - t0
    failures += f
    for k, v in red_launches.items():
        launches[k] = launches.get(k, 0) + v
    summary["seconds"] = secs
    print(f"phase {phase} parts: "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}",
          flush=True)
    return launches, by_shape, summary, failures


# ------------------------------- the mesh and compile machinery (P16)
# phase 15. (a) qwen1.5-0.5b at full width, SL, one step, through the
# training CLI in two processes sharing one fresh kernel-build cache:
# `--mesh test --aot-warmup` (cold: nvcc runs), then `--mesh none
# --aot-warmup` (warm: the library is found); (b) phase 11's live SL
# scheme's `lower_step(make_test_mesh())` against its bytes on the card;
# (c) `launch.serve --mesh test --aot-warmup` on 4 requests against the
# same trace without a mesh
P15_TRAIN = ["--arch", QWEN, "--mode", "sl", "--steps", "1", "--cycle-steps",
             "1", "--split-layer", "2", "--n-train", "16", "--n-test", "8",
             "--aot-warmup"]
P15_SERVE = ["--arch", QWEN, "--requests", "4", "--snr-db", "10",
             "--greedy"]
WARM_OVER_COLD = 0.2         # scripts/ci.sh's gate on the JAX compile cache


def _dry_run_bytes(scheme, exp, seed: int) -> dict:
    """Phase 15 (b), on phase 11's live SL scheme: `lower_step` on the
    one-card test mesh, its argument bytes against the bytes of the
    scheme's state and one batch on the card."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.nn import tree_leaves
    st = exp.final_state
    x, y = st.data
    batch = scheme._sample_batch(x, y, np.random.default_rng(seed),
                                 scheme.shape.global_batch)
    train = st.train
    leaves = (tree_leaves(train.trainable) + tree_leaves(train.opt_state.mu)
              + tree_leaves(train.opt_state.nu) + list(batch.values()))
    if not all(t.is_cuda for t in leaves):
        fail("phase 15: the live SL scheme holds a tensor off the card")
    live = sum(t.numel() * t.element_size() for t in leaves)
    mem = scheme.lower_step(make_test_mesh()).memory_analysis()
    return {"argument_size_in_bytes": mem.argument_size_in_bytes,
            "live_state_and_batch_bytes": live,
            "alias_size_in_bytes": mem.alias_size_in_bytes,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _train_cli(extra: list, cache: str, out: Path) -> dict:
    """`python -m repro_torch.launch.train` in a process of its own with
    the kernel-build cache at `cache`; its wall, its printed warm-up
    wall and its --report-json."""
    import os
    env = dict(os.environ, REPRO_TORCH_KERNEL_CACHE_DIR=cache,
               PYTHONPATH=str(ROOT / "src"))
    if sys.pycache_prefix:
        env["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *P15_TRAIN, *extra, "--report-json", str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 15: launch.train {extra} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    warm = [float(line.split("=", 1)[1]) for line in proc.stdout.split("\n")
            if line.startswith("aot_warmup_compile_wall_s=")]
    rec = json.loads(out.read_text())
    rec.update(process_s=wall, aot_warmup_compile_wall_s=warm[0])
    return rec


def _serve_summary(out: dict) -> tuple:
    d = out["report"]
    return (out["generated"].tolist(), d["bits"], d["energy_j"],
            d["erased_bits"], [(r.bits, r.n_tx, r.energy_j)
                               for r in out["results"]])


def mesh_phase(seed: int, card_name: str, dry_run: dict) -> tuple:
    """Phase 15. Returns ({kernel: launches}, summary, failures)."""
    from repro_torch.launch import serve
    failures, secs = [], {}
    t0 = time.perf_counter()
    cache = tempfile.mkdtemp(prefix="p15_kernels_")
    try:
        cold = _train_cli(["--mesh", "test", "--seed", str(seed)], cache,
                          Path(cache) / "cold.json")
        warm = _train_cli(["--mesh", "none", "--seed", str(seed)], cache,
                          Path(cache) / "warm.json")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    secs["train_cold_warm"] = time.perf_counter() - t0
    c_s, w_s = (r["aot_warmup_compile_wall_s"] for r in (cold, warm))
    print(f"phase 15 (a): qwen SL through launch.train, kernel-build cache "
          f"cold (--mesh test) {c_s:.6f} s, warm (--mesh none) {w_s:.6f} s "
          f"= {w_s / c_s:.5f} of cold; processes {cold['process_s']:.1f} / "
          f"{warm['process_s']:.1f} s; bills {cold['reports']} / "
          f"{warm['reports']}; accuracy {cold['accuracy']} / "
          f"{warm['accuracy']}; K1 {cold['kernel_launches']['packed_wire_2d']}"
          f" / {warm['kernel_launches']['packed_wire_2d']} ({card_name})",
          flush=True)
    if not w_s < WARM_OVER_COLD * c_s:
        failures.append(f"phase 15: warm warm-up {w_s} s not below "
                        f"{WARM_OVER_COLD} x cold {c_s} s")
    if (cold["reports"], cold["accuracy"]) != (warm["reports"],
                                               warm["accuracy"]):
        failures.append("phase 15: --mesh test and --mesh none bill or "
                        "learn differently")
    if cold["device"] != "cuda" or warm["device"] != "cuda":
        failures.append("phase 15: a training run left the card")
    for r in (cold, warm):
        if r["kernel_launches"]["packed_wire_2d"] != 3:   # 2 legs + 1 eval
            failures.append(f"phase 15: K1 launched "
                            f"{r['kernel_launches']['packed_wire_2d']} "
                            f"times, want 3 (two legs, one eval slice)")
    print(f"phase 15 (b): phase 11's SL scheme, lower_step(make_test_mesh())"
          f" argument bytes {dry_run['argument_size_in_bytes']:,}, its state"
          f" and a batch on the card {dry_run['live_state_and_batch_bytes']:,}"
          f"; max_memory_allocated {dry_run['max_memory_allocated']:,}",
          flush=True)
    if dry_run["argument_size_in_bytes"] != \
            dry_run["live_state_and_batch_bytes"]:
        failures.append("phase 15: lower_step's argument bytes are not the "
                        "live scheme's")
    t0 = time.perf_counter()
    counters = _all_counters()
    for f in counters.values():
        f.launches = 0
    served = {}
    for mesh in ("test", "none"):
        extra = ["--aot-warmup"] if mesh == "test" else []
        served[mesh] = serve.main(P15_SERVE + ["--seed", str(seed),
                                               "--mesh", mesh] + extra)
    launches = {k: f.launches for k, f in counters.items()}
    secs["serve"] = time.perf_counter() - t0
    same = _serve_summary(served["test"]) == _serve_summary(served["none"])
    print(f"phase 15 (c): launch.serve --mesh test --aot-warmup = --mesh "
          f"none on 4 requests: {same}; bits "
          f"{served['test']['report']['bits']}; launches {launches}",
          flush=True)
    if not same:
        failures.append("phase 15: serving under the test mesh gave other "
                        "tokens or bills")
    for k in ("paged_decode_attention", "paged_prefill_attention"):
        if launches[k] == 0:
            failures.append(f"phase 15: {k} did not launch while serving")
    for r in (cold, warm):
        launches["packed_wire_2d"] += r["kernel_launches"]["packed_wire_2d"]
    print(f"phase 15 parts: "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}",
          flush=True)
    summary = dict(cold=cold, warm=warm, warm_over_cold=w_s / c_s,
                   dry_run=dry_run, serve_same=same, seconds=secs)
    return launches, summary, failures


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
    # bytecode of what this process imports from here on (torch, the
    # port) goes to a directory of its own, which phase 15's training
    # processes read: the card's Python finds no usable .pyc for torch,
    # and compiling its modules costs a fresh process ~7 s
    pyc = tempfile.mkdtemp(prefix="chip_smoke_pyc_")
    atexit.register(shutil.rmtree, pyc, ignore_errors=True)
    sys.pycache_prefix = pyc
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
    spilled, usage = [], ptxas_usage(logs)
    for lib, fn, regs, spill in usage:
        print(f"  {lib}: {fn}: {regs} registers, spill stores/loads "
              f"{spill[0]}/{spill[1]} bytes")
        if ("gqa" in fn or lib in NO_SPILL_LIBS) and any(spill):
            spilled.append(fn)
    if spilled:
        fail(f"kernels that must not spill do: {spilled}")
    for body in ("split_decode_kernel", "prefill_mma_kernel"):
        for cols in ("DenseCols", "PagedCols"):
            if not any("gqa" in fn and body in fn and cols in fn
                       for _, fn, _, _ in usage):
                fail(f"no {body} instance over {cols} in the build log: "
                     f"the spill check did not see it")

    from repro_torch.serve import make_trace
    S = max(8, make_trace(args.seed, 24, prompt_lens=(32, 256),
                          new_tokens=(16, 64)).max_seq_len())
    S = 16 * math.ceil(S / 16)
    S_wide = 16 * math.ceil(max(8, make_trace(
        args.seed, 16, **MOE_TRACE).max_seq_len()) / 16)
    print(f"kernel checks at the main path's shapes (S {S}; phase 12's "
          f"heads at S {S_wide})", flush=True)
    t_check = time.perf_counter()
    rows, failures, sweep = check_kernels(S, args.seed, S_wide)
    print(f"attention kernel checks: {time.perf_counter() - t_check:.1f} s",
          flush=True)
    floor = launch_floor_ms()
    print(f"timing harness: one one-element add_ per call takes {floor:.5f}"
          f" ms (the per-launch floor)", flush=True)
    print("packed-wire kernel checks at the training path's shapes",
          flush=True)
    wire_rows, wire_failures = check_wire_kernels(args.seed)
    failures += wire_failures
    print("K3 / K4 checks at the tiny model's shapes", flush=True)
    tiny_rows, tiny_summary, tiny_failures = check_tiny_kernels(args.seed)
    failures += tiny_failures
    t_serve = time.perf_counter()
    launches, summary, serve_failures = serve_phase(args.seed)
    print(f"serving phase: {time.perf_counter() - t_serve:.1f} s",
          flush=True)
    failures += serve_failures
    t_train = time.perf_counter()
    shapes = {}
    train_launches, train_summary, train_failures, card_runs = \
        train_phase(args.seed, shapes)
    fl_run = card_runs["fl"]
    print(f"training phase: {time.perf_counter() - t_train:.1f} s; "
          f"launches on the training path {train_launches}", flush=True)
    failures += train_failures
    t_priv = time.perf_counter()
    priv_launches, priv_summary, priv_failures = privacy_phase(
        args.seed, fl_run, card, shapes)
    print(f"privacy phase: {time.perf_counter() - t_priv:.1f} s; launches "
          f"on its path {priv_launches}", flush=True)
    failures += priv_failures
    t_fig3 = time.perf_counter()
    fig3_launches, fig3_summary, fig3_failures = fig3_phase(
        args.seed, card, shapes)
    print(f"Fig. 3 phase: {time.perf_counter() - t_fig3:.1f} s; launches "
          f"on its path {fig3_launches}", flush=True)
    failures += fig3_failures
    from repro_torch.nn import tree_leaves
    cl_model = card_runs["cl"]["exp"].final_state.train.trainable["model"]
    t_tiny = time.perf_counter()
    tiny_launches, tiny_serve_summary, tiny_serve_failures = \
        tiny_serve_phase(args.seed, cl_model, shapes)
    print(f"tiny serving phase: {time.perf_counter() - t_tiny:.1f} s; "
          f"launches {tiny_launches}", flush=True)
    failures += tiny_serve_failures
    t_opt = time.perf_counter()
    weights = torch.cat([a.detach().reshape(-1).cpu()
                         for a in tree_leaves(cl_model)])
    opt_launches, opt_summary, opt_failures = options_phase(
        args.seed, card_runs["sl"], weights, card, shapes)
    print(f"FL/SL options phase: {time.perf_counter() - t_opt:.1f} s; "
          f"launches {opt_launches}", flush=True)
    failures += opt_failures
    t_fleet = time.perf_counter()
    fleet_launches, fleet_summary, fleet_failures = fleet_phase(
        args.seed, card, shapes)
    print(f"fleets, faults and resume phase: "
          f"{time.perf_counter() - t_fleet:.1f} s; launches "
          f"{fleet_launches}", flush=True)
    failures += fleet_failures
    t_qwen = time.perf_counter()
    qwen_launches, qwen_summary, qwen_timed, qwen_failures = scaled_phase(
        args.seed, card, shapes)
    print(f"qwen1.5-0.5b training phase: "
          f"{time.perf_counter() - t_qwen:.1f} s; launches "
          f"{qwen_launches}", flush=True)
    failures += qwen_failures
    t_wide = time.perf_counter()
    wide_launches, wide_by_shape, wide_summary, wide_failures = wide_phase(
        args.seed, card, shapes)
    print(f"moe and wide-head phase: {time.perf_counter() - t_wide:.1f} s; "
          f"launches {wide_launches}", flush=True)
    failures += wide_failures
    t_ssm = time.perf_counter()
    ssm_launches, _, ssm_summary, ssm_failures = family_phase(
        args.seed, card, shapes, (XLSTM,), ("cl", "sl", "fl"),
        REDUCED_TRAINED, 13)
    print(f"ssm and reduced vlm phase: {time.perf_counter() - t_ssm:.1f} s;"
          f" launches {ssm_launches}", flush=True)
    failures += ssm_failures
    t_p14 = time.perf_counter()
    p14_launches, p14_by_shape, p14_summary, p14_failures = family_phase(
        args.seed, card, shapes, (HYBRID, AUDIO), ("cl", "sl"),
        (HYBRID, AUDIO), 14)
    print(f"hybrid and audio phase: {time.perf_counter() - t_p14:.1f} s; "
          f"launches {p14_launches}", flush=True)
    failures += p14_failures
    t_p15 = time.perf_counter()
    p15_launches, p15_summary, p15_failures = mesh_phase(
        args.seed, card, qwen_summary["runs"]["sl"]["dry_run"])
    print(f"mesh and compile phase: {time.perf_counter() - t_p15:.1f} s; "
          f"launches {p15_launches}", flush=True)
    failures += p15_failures
    # the serving paths' launches by (rows, KV heads, G, hd): phase 3
    # (qwen1.5-0.5b) and phase 12 on the engine's 8 slots, phase 14 on the
    # static loop's 4 rows
    attn = {k: {(8, 16, 1, 64): n} for k, n in launches.items()}
    for k, n in p15_launches.items():        # phase 15's 4 slots
        if k in attn:
            attn[k][(4, 16, 1, 64)] = n
    for k, per in wide_by_shape.items():
        for heads, n in per.items():
            attn[k][(8,) + heads] = attn[k].get((8,) + heads, 0) + n
    for k, per in p14_by_shape.items():
        for shp, n in per.items():
            attn[k][shp] = attn[k].get(shp, 0) + n
    for r in rows:
        per = attn.get(r["name"], {})
        r["launches"] = sum(per.values())
        for s in r["by_shape"]:
            s["launches"] = per.get((s["shape"][0],) + tuple(s["shape"][-3:]),
                                    0)
    # the training paths' launches: phases 5 and 7-15
    for r in wire_rows + tiny_rows:
        extra = qwen_timed.get(r["name"])
        if extra:
            if "by_shape" not in r:
                r["by_shape"] = _by_shape({tuple(r["shape"]): {
                    k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}})
            r["by_shape"] += _by_shape(extra)
        r.pop("shape", None)
        r["launches"] = sum(p.get(r["name"], 0) for p in (
            train_launches, priv_launches, fig3_launches, tiny_launches,
            opt_launches, fleet_launches, qwen_launches, wide_launches,
            ssm_launches, p14_launches, p15_launches))
        for s in r.get("by_shape", ()):
            s["launches"] = shapes.get(r["name"], {}).get(tuple(s["shape"]),
                                                          0)
    shapes = {k: {str(list(s)): n for s, n in sorted(c.items())}
              for k, c in shapes.items()}
    print(f"launches by shape over phases 5 and 7-14: {shapes}",
          flush=True)
    rows += wire_rows + tiny_rows
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "kernels": rows,
                                   "decode_split_sweep_ms": sweep,
                                   "serve": summary,
                                   "train": train_summary,
                                   "tiny_kernels": tiny_summary,
                                   "launch_floor_ms": floor,
                                   "launches_by_shape": shapes,
                                   "privacy": priv_summary,
                                   "fig3": fig3_summary,
                                   "tiny_serve": tiny_serve_summary,
                                   "options": opt_summary,
                                   "fleets": fleet_summary,
                                   "qwen_training": qwen_summary,
                                   "moe_and_wide_heads": wide_summary,
                                   "ssm_and_reduced_vlm": ssm_summary,
                                   "hybrid_and_audio": p14_summary,
                                   "mesh_and_compile": p15_summary,
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
