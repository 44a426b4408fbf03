"""Table II — total bits, accuracy, reconstruction error, computation,
communication and total energy and CO2 for CL, FL Q8 and SL — the port
of `benchmarks/table2.py` (`run` / `main`), which stays JAX-only:

    # on the card (the default): CL 20 cycles, FL 7, SL max(20, 35)
    PYTHONPATH=src python -m repro_torch.launch.table2 --out table2.json
    # the plain versions on the CPU, at a small corpus
    PYTHONPATH=src python -m repro_torch.launch.table2 --device cpu \\
        --cycles 1 --fl-cycles 1 --sl-cycles 1 --n-train 1536 \\
        --n-test 256 --adv-steps 20

runs, through `build_scheme(..., capture=True)` + `Experiment`, CL over a
20 dB link, FL at Q8 (20 dB, 3 users, J 5) and fused SL at Q16 (20 dB,
compress 4, a capture every 8 steps); then the paper's privacy study
(Eq. 12) on what crossed the radio, in `benchmarks/table2.py`'s order
(so numpy's streams are drawn in the same order):

  CL: the direct read of the received corpus (its first 4,096 rows);
  FL: a fixed random projection of the 89,673-wide uploads to 1,024
      (`default_rng(0)`), then two attack protocols: A, the dataset
      statistic (each upload against its user's mean token vector) and
      B, per sample (each upload against 64 rows of that user's shard,
      drawn from the same rng);
  SL: the compressed smashed activations (the first 20,000 captured
      rows).

All three adversaries draw from one `AdversaryDraws(seed + 11)`, as JAX's
draw from one `PRNGKey(seed + 11)`. The energy rows bill the user side's
FLOPs and the run's bits; `total_bits_M_paper_scale` scales the bits to
the paper's 1.44 M training rows.

`main` prints JAX's `table2,<row>,<key>,<value>` and `table2,claim,...`
lines letter for letter (`grep '^table2,'` gives the lines to diff),
and beside them each scheme's seconds per cycle, bills and K1 / K3 / K4
launches per round and per eval, the three error ratios next to the
paper's with the error of an adversary that answers the mean token
(`mean_guess_error`), and the card's name and power limit. On the card
it builds the path's kernels (K1, K3, K4) before the first cycle. It
writes JSON only to `--out`, and exits non-zero when a bill differs
from its closed form, a launch count from the path's, a loss or
accuracy is not finite, or err_SL <= err_CL.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import WirelessConfig
from repro_torch.core import energy as EN
from repro_torch.core import privacy as PRIV
from repro_torch.data.sentiment import partition_users
from repro_torch.kernels import launch_counts
from repro_torch.nn import resolve_device
from repro_torch.schemes import (BATCH, CFG, N_TEST, N_TRAIN, Experiment,
                                 build_scheme, corpus)

PAPER_N_TRAIN = 1_440_000   # benchmarks/table2.py:30, 90% of the 1.6M corpus
CL_ROWS = 4096              # benchmarks/table2.py:50, the direct read's rows
FL_PROJ = 1024              # benchmarks/table2.py:65, the projection's width
FL_PER_USER = 64            # benchmarks/table2.py:75, samples per upload
SL_ROWS = 20_000            # benchmarks/table2.py:89, the SL adversary's rows
ADV_STEPS = 600             # benchmarks/table2.py:68, :85, :91
ADV_SEED = 11               # benchmarks/table2.py:46, PRNGKey(seed + 11)
SL_MIN_CYCLES = 35          # benchmarks/table2.py:44, max(cycles, 35)
N_USERS = 3                 # benchmarks/common.py:train_fl, N = 3
CAPTURE_EVERY = 8           # benchmarks/common.py:train_sl
EVAL_BATCH = 2048           # schemes/base.py:evaluate's slice

# row name -> (WirelessConfig, scheme options): benchmarks/table2.py:38-44
# with benchmarks/common.py's FL users and local epochs (J 5)
SCHEMES = {
    "central": (WirelessConfig(mode="cl", snr_db=20.0), {}),
    "fl_q8": (WirelessConfig(mode="fl", quant_bits=8, snr_db=20.0,
                             local_steps=5, n_users=N_USERS), {}),
    "sl_early_cut": (WirelessConfig(mode="sl", quant_bits=16, snr_db=20.0),
                     dict(capture_every=CAPTURE_EVERY)),
}

# the bills in closed form (paper Table II): FL uploads 8 bits for each
# of the 89,673 weights a user a cycle (0.72 Mbit); an SL step carries
# 112 values a row (14 pooled positions x 32 / 4 channels) up and their
# gradients down at 16 bits (2,580.48 Mbit = 720k rows x 112 x 16 x 2);
# CL uploads each row once: 30 tokens of 14 bits (vocab 10,001) and one
# label bit
FL_BITS_PER_USER = 8 * 89_673
SL_BITS_PER_ROW_STEP = 2 * 112 * 16
CL_BITS_PER_ROW = 30 * 14 + 1

# the paper's figures the run is reported beside (not gated)
PAPER = {"sl_over_fl": 4.0, "sl_over_cl": 18.0, "fl_upload_Mbit": 0.72,
         "sl_Mbit": 2580.48}

TINY_KERNELS = ("packed_wire_2d", "conv_pool", "lstm_final_state")
PATH_LIBRARIES = ("quant_channel", "conv_pool", "lstm_cell")


@dataclasses.dataclass
class SchemeRun:
    """One scheme's run: its `RunResult`, round reports and init-time
    upload bits, the seconds of each cycle (round + eval, host clock,
    the card synchronized) and of init, and the (K1, K3, K4) launches
    of each round and each eval."""
    result: object
    reports: list
    init_bits: float
    walls: list
    init_s: float
    round_launches: list
    eval_launches: list


@dataclasses.dataclass
class Table2Run:
    rows: dict
    runs: dict          # row name -> SchemeRun
    other_launches: dict  # kernels off this path that launched (none)
    adversary_s: float
    build_s: float      # the path's kernel libraries built first (card)
    mean_guess: dict    # row name -> `mean_guess_error` of its targets


def _norm(tokens) -> np.ndarray:
    """benchmarks/table2.py:33: tokens / vocab in float32."""
    return np.asarray(tokens).astype(np.float32) / float(CFG.vocab_size)


def _tiny_counts() -> tuple:
    counts = launch_counts()
    return tuple(counts[k] for k in TINY_KERNELS)


def _drive(name: str, cycles: int, seed: int, n_train: int, n_test: int,
           device) -> SchemeRun:
    """One of `SCHEMES` with capture through `Experiment`, counting K1,
    K3 and K4 inside each round and each eval."""
    wcfg, opts = SCHEMES[name]
    scheme = build_scheme(wcfg, capture=True, device=device, **opts)
    rounds, evals, walls, clock = [], [], [], [0.0]

    def counted(fn, out):
        def call(*a):
            n0 = _tiny_counts()
            r = fn(*a)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out.append(tuple(b - a for a, b in zip(n0, _tiny_counts())))
            return r
        return call

    scheme.round = counted(scheme.round, rounds)
    scheme.evaluate = counted(scheme.evaluate, evals)

    def started(state):
        clock[0] = time.perf_counter()

    def on_cycle(cyc, acc, rep):
        now = time.perf_counter()
        walls.append(now - clock[0])
        clock[0] = now

    t0 = time.perf_counter()
    exp = Experiment(scheme, cycles, seed=seed, n_train=n_train,
                     n_test=n_test, on_init=started, on_cycle=on_cycle)
    res = exp.run()
    init_s = time.perf_counter() - t0 - sum(walls)
    return SchemeRun(res, exp.reports, (exp.init_delivery.bits
                                        if exp.init_delivery else 0.0),
                     walls, init_s, rounds, evals)


def sl_pair(captures) -> tuple:
    """benchmarks/table2.py:87-91: the SL adversary's observations (the
    received smashed activations, flattened) and targets (the batch's
    normalized tokens), their first `SL_ROWS` rows."""
    obs = np.concatenate(captures["smashed"], axis=0)
    orig = np.concatenate(captures["original"], axis=0)
    obs = obs.reshape(len(obs), -1)
    n = min(len(obs), SL_ROWS)
    return obs[:n], _norm(orig)[:n]


def adversary_inputs(cl_caps, fl_caps, sl_caps, n_train: int = N_TRAIN,
                     n_test: int = N_TEST) -> dict:
    """Every adversary's (observations, targets), in
    benchmarks/table2.py's order: the CL direct read (:50-51); the FL
    projection, drawn first from `default_rng(0)` (:64-66), the
    statistic protocol's pairs (:67-68), then per (cycle, user) 64 rows
    of that user's shard from the same rng (:72-82); the SL pairs
    (:87-91). Also returns the projection and the drawn rows. The shards
    come from the seed-0 corpus whatever the run's seed, as
    benchmarks/table2.py:72's `corpus()` does."""
    out = {"central": (_norm(cl_caps["received"][:CL_ROWS]),
                       _norm(cl_caps["original"][:CL_ROWS]))}
    deltas = np.concatenate(fl_caps["deltas"], axis=0)
    targets = np.concatenate(fl_caps["targets"], axis=0)
    rngp = np.random.default_rng(0)
    proj = rngp.standard_normal((deltas.shape[1], FL_PROJ)).astype(
        np.float32)
    proj /= np.sqrt(deltas.shape[1])
    out["proj"] = proj
    out["fl_statistic"] = (deltas @ proj, _norm(targets))
    (xtr, _), _ = corpus(n_train, n_test)
    shards = partition_users(xtr, np.zeros(len(xtr), np.int32), N_USERS)
    obs_b, tgt_b, drawn = [], [], []
    for d in fl_caps["deltas"]:
        for u in range(N_USERS):
            idx = rngp.integers(0, len(shards[u][0]), FL_PER_USER)
            drawn.append(idx)
            obs_b.append(np.repeat((d[u] @ proj)[None], FL_PER_USER,
                                   axis=0))
            tgt_b.append(shards[u][0][idx])
    out["fl_rows"] = drawn
    out["fl_per_sample"] = (np.concatenate(obs_b),
                            _norm(np.concatenate(tgt_b)))
    out["sl"] = sl_pair(sl_caps)
    return out


def energy_row(res, wcfg, err: float, n_train: int = N_TRAIN) -> dict:
    """benchmarks/table2.py:104-113: one row's bits, accuracy, error and
    energy, in JAX's key order."""
    comp = EN.comp_energy_j(res.user_flops)
    comm = EN.comm_energy_j(res.total_bits, wcfg)
    return {
        "total_bits_M": res.total_bits / 1e6,
        "total_bits_M_paper_scale":
            res.total_bits * (PAPER_N_TRAIN / n_train) / 1e6,
        "accuracy": res.final_accuracy,
        "recon_error": float(err),
        "comp_energy_j": comp,
        "comm_energy_j": comm,
        "total_energy_j": comp + comm,
        "co2_kg": EN.co2_kg(comp + comm),
    }


def rows_from_runs(cl, fl, sl, draws, *, adv_steps: int = ADV_STEPS,
                   n_train: int = N_TRAIN, n_test: int = N_TEST,
                   device="cuda", inputs=None) -> dict:
    """Table II's rows from the three `RunResult`s' captures, assembled
    as benchmarks/table2.py:46-114 does: rows `central`, `fl_q8_extra`
    (the statistic protocol's error), `fl_q8` (the per-sample protocol's)
    and `sl_early_cut`. `draws` is the adversaries' `AdversaryDraws` (the
    same for all three); they train on `device`. `inputs`, when given, is
    `adversary_inputs` of the same captures, drawn already."""
    obs = inputs or adversary_inputs(cl.captures, fl.captures,
                                     sl.captures, n_train, n_test)

    def adversary(pair):
        return PRIV.reconstruction_error(draws, *pair, steps=adv_steps,
                                         device=device)

    err = {"central": PRIV.direct_error(*obs["central"])}
    err_fl_stat = adversary(obs["fl_statistic"])
    err["fl_q8"] = adversary(obs["fl_per_sample"])
    err["sl_early_cut"] = adversary(obs["sl"])
    rows = {}
    for name, res in (("central", cl), ("fl_q8", fl), ("sl_early_cut", sl)):
        if name == "fl_q8":
            rows["fl_q8_extra"] = {"recon_error_statistic":
                                   float(err_fl_stat)}
        rows[name] = energy_row(res, SCHEMES[name][0], err[name], n_train)
    return rows


def claims(rows: dict) -> list:
    """benchmarks/table2.py:128-141: the paper's qualitative claims as
    (name, bool); FL's privacy under both attack protocols."""
    cl, fl, sl = rows["central"], rows["fl_q8"], rows["sl_early_cut"]
    return [
        ("privacy_sl_gt_cl", sl["recon_error"] > cl["recon_error"]),
        ("privacy_sl_gt_fl_statistic_protocol",
         sl["recon_error"] > rows["fl_q8_extra"]["recon_error_statistic"]),
        ("privacy_sl_gt_fl_per_sample_protocol",
         sl["recon_error"] > fl["recon_error"]),
        ("privacy_fl_gt_cl_per_sample",
         fl["recon_error"] > cl["recon_error"]),
        ("comp_sl_lt_fl", sl["comp_energy_j"] < fl["comp_energy_j"]),
        ("comm_sl_gt_fl", sl["comm_energy_j"] > fl["comm_energy_j"]),
        ("bits_sl_gt_cl_gt_fl",
         sl["total_bits_M"] > cl["total_bits_M"] > fl["total_bits_M"]),
    ]


def lines(rows: dict) -> list:
    """benchmarks/table2.py:main's printed lines (:123-141), letter for
    letter."""
    out = [f"table2,{name},{k},{v:.6g}" for name, r in rows.items()
           for k, v in r.items()]
    return out + [f"table2,claim,{k},{v}" for k, v in claims(rows)]


def mean_guess_error(targets, test_frac: float = 0.2) -> float:
    """The held-out error of an adversary that ignores what it sees and
    answers each position's mean over the training rows (the split of
    `reconstruction_error`): the bar an adversary must pass to have
    learnt anything from the observations."""
    t = np.asarray(targets, np.float32).reshape(len(targets), -1)
    n_test = max(1, int(len(t) * test_frac))
    return float(np.mean(np.square(t[-n_test:] - t[:-n_test].mean(0))))


def ratios(rows: dict) -> dict:
    """The error ratios the paper reports (~4 and ~18), and FL / CL."""
    cl, fl, sl = (rows[k]["recon_error"] for k in
                  ("central", "fl_q8", "sl_early_cut"))
    return {"sl_over_fl": sl / fl, "sl_over_cl": sl / cl,
            "fl_over_cl": fl / cl}


def run(cycles: int = 20, fl_cycles: int = 7, seed: int = 0, *,
        sl_cycles=None, n_train: int = N_TRAIN, n_test: int = N_TEST,
        adv_steps: int = ADV_STEPS, device="cuda") -> Table2Run:
    """benchmarks/table2.py:run: CL `cycles`, FL `fl_cycles` and SL
    `sl_cycles` (None: max(cycles, 35), JAX's rule) with capture, then
    `rows_from_runs`. `n_train` / `n_test` / `adv_steps` default to
    JAX's and exist so that a CPU run can be small."""
    device = resolve_device(device)
    sl_cycles = max(cycles, SL_MIN_CYCLES) if sl_cycles is None \
        else sl_cycles
    build_s = 0.0
    if device.type == "cuda":       # not inside the first cycle's time
        from repro_torch.kernels import build
        build_s = build.build_all(PATH_LIBRARIES)[0]
    before = launch_counts()
    runs = {name: _drive(name, c, seed, n_train, n_test, device)
            for name, c in (("central", cycles), ("fl_q8", fl_cycles),
                            ("sl_early_cut", sl_cycles))}
    other = {k: n - before[k] for k, n in launch_counts().items()
             if k not in TINY_KERNELS and n != before[k]}
    t0 = time.perf_counter()
    results = [runs[k].result for k in ("central", "fl_q8", "sl_early_cut")]
    inputs = adversary_inputs(*(r.captures for r in results), n_train,
                              n_test)
    rows = rows_from_runs(*results, PRIV.AdversaryDraws(seed + ADV_SEED),
                          adv_steps=adv_steps, n_train=n_train,
                          n_test=n_test, device=device, inputs=inputs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    guess = {"fl_q8": mean_guess_error(inputs["fl_per_sample"][1]),
             "sl_early_cut": mean_guess_error(inputs["sl"][1])}
    return Table2Run(rows, runs, other, time.perf_counter() - t0, build_s,
                     guess)


def closed_form_bills(n_train: int = N_TRAIN) -> dict:
    """row name -> (init-time bits, bits a cycle, the users that
    `RunResult.total_bits` divides by) in closed form."""
    return {"central": (float(n_train * CL_BITS_PER_ROW), 0.0, 1),
            "fl_q8": (0.0, float(N_USERS * FL_BITS_PER_USER), N_USERS),
            "sl_early_cut": (0.0, float(n_train // BATCH * BATCH
                                        * SL_BITS_PER_ROW_STEP), 1)}


def path_launches(n_train: int = N_TRAIN, n_test: int = N_TEST) -> dict:
    """row name -> ((K1, K3, K4) a round, (K1, K3, K4) an eval) on the
    card: FL's sync is one K1; an SL step is two K1 legs, and a capture
    step one more K1 and one K3 (no grad); each eval slice is K3 + K4
    once (SL's also one K1); training under autograd runs no kernel."""
    steps = n_train // BATCH
    n_cap = -(-steps // CAPTURE_EVERY)
    slices = max(1, n_test // EVAL_BATCH)
    return {"central": ((0, 0, 0), (0, slices, slices)),
            "fl_q8": ((1, 0, 0), (0, slices, slices)),
            "sl_early_cut": ((2 * steps + n_cap, n_cap, 0),
                             (slices, slices, slices))}


def failures(t2: Table2Run, device, n_train: int = N_TRAIN,
             n_test: int = N_TEST) -> list:
    """What the run must meet: bills equal to their closed form; the
    path's launches (none on the CPU); finite losses and accuracies;
    err_SL > err_CL."""
    out = []
    bills = closed_form_bills(n_train)
    want = path_launches(n_train, n_test)
    on_card = torch.device(device).type == "cuda"
    for name, r in t2.runs.items():
        init, per, users = bills[name]
        got = [rep.bits for rep in r.reports]
        if r.init_bits != init or got != [per] * len(got) or \
                r.result.total_bits != (init + per * len(got)) / users:
            out.append(f"{name}: bills init {r.init_bits}, per cycle "
                       f"{sorted(set(got))}, total {r.result.total_bits}; "
                       f"closed form {init} + {per} a cycle")
        w = want[name] if on_card else ((0, 0, 0), (0, 0, 0))
        if any(x != w[0] for x in r.round_launches) or \
                any(x != w[1] for x in r.eval_launches):
            out.append(f"{name}: (K1, K3, K4) launches per round "
                       f"{dict(collections.Counter(r.round_launches))}, "
                       f"per eval "
                       f"{dict(collections.Counter(r.eval_launches))}; "
                       f"want {w}")
        if not all(math.isfinite(v) for v in
                   r.result.accuracy + r.result.loss):
            out.append(f"{name}: a non-finite accuracy or loss")
    if t2.other_launches:
        out.append(f"kernels off the path launched: {t2.other_launches}")
    err_sl = t2.rows["sl_early_cut"]["recon_error"]
    err_cl = t2.rows["central"]["recon_error"]
    if not err_sl > err_cl:
        out.append(f"privacy: err_SL {err_sl} <= err_CL {err_cl}")
    return out


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "none (the CPU's plain versions)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def summary(t2: Table2Run) -> dict:
    """Each scheme's cycles, seconds, bills, launches and scores."""
    out = {}
    for name, r in t2.runs.items():
        out[name] = dict(
            cycles=len(r.walls), s_per_cycle=r.walls, init_s=r.init_s,
            init_bits=r.init_bits, bits=[rep.bits for rep in r.reports],
            n_tx=[rep.n_tx for rep in r.reports],
            accuracy=r.result.accuracy, loss=r.result.loss,
            launches_round=r.round_launches, launches_eval=r.eval_launches)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cycles", type=int, default=20, help="CL cycles")
    ap.add_argument("--fl-cycles", type=int, default=7)
    ap.add_argument("--sl-cycles", type=int, default=None,
                    help="default max(--cycles, 35)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-train", type=int, default=N_TRAIN,
                    help="training rows (smaller for a CPU run)")
    ap.add_argument("--n-test", type=int, default=N_TEST)
    ap.add_argument("--adv-steps", type=int, default=ADV_STEPS,
                    help="adversary steps (smaller for a CPU run)")
    ap.add_argument("--out", default="", help="write the JSON here")
    return ap.parse_args(argv)


def main(argv=None) -> Table2Run:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # f32 products and convolutions, as the reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = card_line(device)
    print(f"table2 card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {device}", flush=True)
    t0 = time.perf_counter()
    t2 = run(args.cycles, args.fl_cycles, args.seed,
             sl_cycles=args.sl_cycles, n_train=args.n_train,
             n_test=args.n_test, adv_steps=args.adv_steps, device=device)
    wall = time.perf_counter() - t0
    runs = summary(t2)
    print(f"table2 kernels built first: {t2.build_s:.2f} s", flush=True)
    for name, s in runs.items():
        walls = s["s_per_cycle"]
        steady = float(np.mean(walls[1:] or walls))
        print(f"table2 run {name}: {s['cycles']} cycles, s per cycle "
              f"{walls[0]:.4f} the first, mean {steady:.4f} after it (min "
              f"{min(walls):.4f}, max "
              f"{max(walls):.4f}), init {s['init_s']:.3f} s; bits init "
              f"{s['init_bits']:.0f}, per cycle "
              f"{sorted(set(s['bits']))}, total "
              f"{t2.runs[name].result.total_bits:.0f}; n_tx per cycle "
              f"{sorted(set(s['n_tx']))}; (K1, K3, K4) launches per round "
              f"{dict(collections.Counter(s['launches_round']))}, per "
              f"eval {dict(collections.Counter(s['launches_eval']))}; "
              f"accuracy last {s['accuracy'][-1]:.4f}, loss last "
              f"{s['loss'][-1]:.4f}", flush=True)
    for line in lines(t2.rows):
        print(line)
    rat = ratios(t2.rows)
    print(f"table2 ratios (reported, not gated): err_SL / err_FL "
          f"{rat['sl_over_fl']:.4f} (paper ~{PAPER['sl_over_fl']:g}), "
          f"err_SL / err_CL {rat['sl_over_cl']:.4f} (paper "
          f"~{PAPER['sl_over_cl']:g}), err_FL / err_CL "
          f"{rat['fl_over_cl']:.4f}; an adversary answering the mean "
          f"token scores {t2.mean_guess['fl_q8']:.6g} on FL's per-sample "
          f"targets, {t2.mean_guess['sl_early_cut']:.6g} on SL's; "
          f"adversaries {t2.adversary_s:.2f} s; wall {wall:.1f} s on "
          f"{card}", flush=True)
    bad = failures(t2, device, args.n_train, args.n_test)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": str(device),
                       "args": vars(args), "rows": t2.rows,
                       "claims": dict(claims(t2.rows)), "ratios": rat,
                       "paper": PAPER, "mean_guess": t2.mean_guess,
                       "runs": runs, "build_s": t2.build_s,
                       "adversary_s": t2.adversary_s, "wall_s": wall,
                       "failures": bad}, f, indent=1)
    for msg in bad:
        print(f"table2 FAILED: {msg}", file=sys.stderr, flush=True)
    if bad:
        raise SystemExit(1)
    return t2


if __name__ == "__main__":
    main()
