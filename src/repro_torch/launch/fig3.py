"""Fig. 3 — the paper's four accuracy panels, the port of
`benchmarks/accuracy_cycles.py` (3a), `quant_sweep.py` (3b),
`snr_sweep.py` (3c) and `fading.py` (3d) at `benchmarks/run.py`'s cycle
counts; those scripts stay JAX-only:

    # on the card (the default): the quick counts, 16 / 5 / 6 / 12 cycles
    PYTHONPATH=src python -m repro_torch.launch.fig3 --out fig3.json
    # the paper's 50 / 7 / 10 / 20, a panel or two a card call
    PYTHONPATH=src python -m repro_torch.launch.fig3 --full --panels a,b
    # the plain versions on the CPU, one cycle a run at a small corpus
    PYTHONPATH=src python -m repro_torch.launch.fig3 --device cpu \\
        --cycles 1 --fl-cycles 1 --sl-cycles 1 --n-train 1536 --n-test 256

Each run goes through `build_scheme` + `Experiment` as
`benchmarks/common.py`'s `train_cl` / `train_fl` / `train_sl` drive it
(FL with J 5 local epochs and N 3 users; SL at the link's bits with a
capture every 8 steps, capture off), in the JAX scripts' order, with
their configurations and seeds:

  3a  CL with no radio for `cycles`; FL Q8 and FL Q32 for 7 cycles (20 dB,
      fading); SL Q16 for max(cycles, 35);
  3b  FL at Q4, Q8, Q16 and Q32 for `cycles`;
  3c  at each SNR of (0, 5, 10, 15, 20, 30) dB, or (0, 10, 20, 30) when
      cycles < 10: CL at that SNR for `cycles`, FL Q8 and FL Q8 with ARQ
      (4 attempts) for 5 cycles, SL Q16 for max(cycles, 28), on a corpus
      of 12,288 / 2,048 rows;
  3d  CL with no radio and CL at 20 dB with fading for `cycles`, FL Q8
      for 7 cycles, SL Q16 for max(cycles, 35).

`main` prints the JAX scripts' `fig3a,...` to `fig3d,...` lines letter for
letter (`grep '^fig3'` gives the lines to diff) and, on lines of their
own starting `#`, each run's seconds per cycle after the first and its
init seconds, its bills against their closed form (`table2.
closed_form_bits`; FL with ARQ: the wire width x the packet sizes x the
n_tx its draws give, replayed), its K1 / K3 / K4 launches per round and
per eval against the path's (`table2.mode_launches`), and the card's
name and power limit. On the card it builds the path's kernels (K1, K3,
K4) first. It writes JSON only to `--out`, and exits non-zero when a
bill or a launch count differs or a loss or accuracy is not finite. The
paper's claims are printed as the JAX scripts print them, not gated.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import WirelessConfig
from repro_torch.core import wire as W
from repro_torch.kernels import launch_counts
from repro_torch.launch import table2 as T2
from repro_torch.nn import resolve_device, tree_leaves
from repro_torch.runtime.fl_runtime import SYNC_KEY_FOLD
from repro_torch.schemes import N_TEST, N_TRAIN

PANELS = ("a", "b", "c", "d")
QUICK = {"a": 16, "b": 5, "c": 6, "d": 12}       # benchmarks/run.py:18-35
FULL = {"a": 50, "b": 7, "c": 10, "d": 20}       # the same, with --full
# FL's cycles where a panel fixes them: accuracy_cycles.py:19,
# snr_sweep.py:23, fading.py:19 (3b's FL runs take `cycles`)
FL_CYCLES = {"a": 7, "c": 5, "d": 7}
# SL's least cycles, max(cycles, n): accuracy_cycles.py:29,
# snr_sweep.py:42, fading.py:31
SL_MIN_CYCLES = {"a": 35, "c": 28, "d": 35}
BITS = (4, 8, 16, 32)                            # quant_sweep.py:18
SNRS = (0.0, 5.0, 10.0, 15.0, 20.0, 30.0)        # snr_sweep.py:19
SNRS_QUICK = (0.0, 10.0, 20.0, 30.0)             # snr_sweep.py:20
SNR_N_TRAIN, SNR_N_TEST = 12_288, 2_048          # snr_sweep.py:24
SNR_SERIES = ("cl", "fl", "fl_arq", "sl")        # snr_sweep.py:26-27
ARQ_ATTEMPTS = 4                                 # snr_sweep.py:38


@dataclasses.dataclass(frozen=True)
class Spec:
    """One run of a panel: the key of JAX's result dict it fills, the
    `WirelessConfig` that `benchmarks/common.py` hands `build_scheme`
    (None: CL with no radio), its cycles, seed and corpus, and (3c) the
    SNR it belongs to."""
    panel: str
    series: str
    wcfg: Optional[WirelessConfig]
    cycles: int
    seed: int
    n_train: int
    n_test: int
    snr_db: Optional[float] = None

    @property
    def mode(self) -> str:
        return "cl" if self.wcfg is None else self.wcfg.mode

    @property
    def name(self) -> str:
        snr = "" if self.snr_db is None else f" {self.snr_db:g} dB"
        return f"fig3{self.panel} {self.series}{snr}"

    def options(self) -> dict:
        """`train_sl`'s capture_every (common.py:train_sl)."""
        return dict(capture_every=T2.CAPTURE_EVERY) \
            if self.mode == "sl" else {}


def _fl(**kw) -> WirelessConfig:
    """common.py:train_fl's config: J 5 local epochs, N 3 users."""
    return WirelessConfig(mode="fl", local_steps=5, n_users=T2.N_USERS, **kw)


def _sl(**kw) -> WirelessConfig:
    return WirelessConfig(mode="sl", quant_bits=16, **kw)


def plan(panel: str, cycles: int, seed: int = 0, *, fl_cycles=None,
         sl_cycles=None, n_train=None, n_test=None) -> list:
    """A panel's runs in its JAX script's order (`run`). `fl_cycles` /
    `sl_cycles` (None: the script's 7 or 5 and its max(cycles, n) rule)
    and `n_train` / `n_test` (None: the script's corpus) exist so that a
    run can be short."""
    fl_c = FL_CYCLES.get(panel, cycles) if fl_cycles is None else fl_cycles
    sl_c = max(cycles, SL_MIN_CYCLES.get(panel, 0)) if sl_cycles is None \
        else sl_cycles
    if panel == "c":
        nt = SNR_N_TRAIN if n_train is None else n_train
        ns = SNR_N_TEST if n_test is None else n_test
    else:
        nt = N_TRAIN if n_train is None else n_train
        ns = N_TEST if n_test is None else n_test

    def spec(series, wcfg, c, snr=None):
        return Spec(panel, series, wcfg, c, seed, nt, ns, snr)

    if panel == "a":                       # accuracy_cycles.py:19-33
        return [spec("cl", None, cycles),
                spec("fl_q8", _fl(quant_bits=8), fl_c),
                spec("fl_q32", _fl(quant_bits=32), fl_c),
                spec("sl", _sl(), sl_c)]
    if panel == "b":                       # quant_sweep.py:21-27
        return [spec(f"q{b}", _fl(quant_bits=b), cycles) for b in BITS]
    if panel == "c":                       # snr_sweep.py:23-45
        out = []
        for snr in (SNRS if cycles >= 10 else SNRS_QUICK):
            out += [spec("cl", WirelessConfig(mode="cl", snr_db=snr),
                         cycles, snr),
                    spec("fl", _fl(quant_bits=8, snr_db=snr), fl_c, snr),
                    spec("fl_arq", _fl(quant_bits=8, snr_db=snr,
                                       arq_attempts=ARQ_ATTEMPTS), fl_c,
                         snr),
                    spec("sl", _sl(snr_db=snr), sl_c, snr)]
        return out
    if panel == "d":                       # fading.py:19-37
        return [spec("cl_clean", None, cycles),
                spec("cl_fading", WirelessConfig(mode="cl", snr_db=20.0,
                                                 fading=True), cycles),
                spec("fl_q8_fading", _fl(quant_bits=8, snr_db=20.0,
                                         fading=True), fl_c),
                spec("sl_fading", _sl(snr_db=20.0, fading=True), sl_c)]
    raise ValueError(f"unknown Fig. 3 panel {panel!r} (one of {PANELS})")


def panel_result(specs: list, results: list) -> dict:
    """JAX's `run` dict from the runs' `RunResult`s: series -> per-cycle
    accuracy, or (3c) snr_db and series -> each SNR's final accuracy."""
    if specs and specs[0].panel == "c":
        out = {"snr_db": [s.snr_db for s in specs if s.series == "cl"]}
        for m in SNR_SERIES:
            out[m] = [r.final_accuracy for s, r in zip(specs, results)
                      if s.series == m]
        return out
    return {s.series: r.accuracy for s, r in zip(specs, results)}


def lines(panel: str, res: dict) -> list:
    """The panel's `main` lines, letter for letter."""
    if panel == "c":                       # snr_sweep.py:53-62
        rows = [f"fig3c,{m},snr{snr:g}dB,{acc:.4f}" for m in SNR_SERIES
                for snr, acc in zip(res["snr_db"], res[m])]
        return rows + [f"fig3c,{m},plateau_20db_gap,"
                       f"{abs(res[m][-1] - res[m][-2]):.4f}"
                       for m in SNR_SERIES]
    last = 2 if panel == "b" else 3
    final = {k: float(np.mean(v[-last:])) for k, v in res.items()}
    rows = [f"fig3{panel},{k},final_acc,{final[k]:.4f}" for k in res]
    if panel == "a":                       # accuracy_cycles.py:42-47
        parity = max(abs(final[m] - final["cl"])
                     for m in ("fl_q8", "fl_q32", "sl"))
        return rows + [f"fig3a,parity_gap_max,claim<0.02,{parity:.4f}"]
    if panel == "b":                       # quant_sweep.py:36-41
        return rows + [
            f"fig3b,q4_below_q8,claim,{final['q4'] <= final['q8'] + 0.005}",
            f"fig3b,q8_matches_q32,claim,"
            f"{abs(final['q8'] - final['q32']) < 0.02}"]
    return rows + [                        # fading.py:46-54
        f"fig3d,cl_degradation,claim>=0,"
        f"{final['cl_clean'] - final['cl_fading']:.4f}",
        f"fig3d,fl_robust,gap_to_clean,"
        f"{final['cl_clean'] - final['fl_q8_fading']:.4f}",
        f"fig3d,sl_robust,gap_to_clean,"
        f"{final['cl_clean'] - final['sl_fading']:.4f}"]


@dataclasses.dataclass
class Fig3Run:
    specs: dict           # panel -> [Spec]
    runs: dict            # panel -> [table2.SchemeRun], as specs
    results: dict         # panel -> JAX's `run` dict
    other_launches: dict  # kernels off this path that launched (none)
    build_s: float        # the path's kernel libraries built first (card)


def run(panels=PANELS, full: bool = False, seed: int = 0, *, cycles=None,
        fl_cycles=None, sl_cycles=None, n_train=None, n_test=None,
        device="cuda", drive=None) -> Fig3Run:
    """Each panel's `plan` through `drive` (default `table2.drive`), at
    `benchmarks/run.py`'s quick or (`full`) paper cycle counts unless
    `cycles` is given."""
    device = resolve_device(device)
    drive = drive or T2.drive
    build_s = 0.0
    if device.type == "cuda":       # not inside the first cycle's time
        from repro_torch.kernels import build
        build_s = build.build_all(T2.PATH_LIBRARIES)[0]
    before = launch_counts()
    specs, runs, results = {}, {}, {}
    for p in panels:
        c = (FULL if full else QUICK)[p] if cycles is None else cycles
        specs[p] = plan(p, c, seed, fl_cycles=fl_cycles,
                        sl_cycles=sl_cycles, n_train=n_train, n_test=n_test)
        runs[p] = [drive(s.wcfg, s.cycles, s.seed, s.n_train, s.n_test,
                         device, **s.options()) for s in specs[p]]
        results[p] = panel_result(specs[p], [r.result for r in runs[p]])
    other = {k: n - before[k] for k, n in launch_counts().items()
             if k not in T2.TINY_KERNELS and n != before[k]}
    return Fig3Run(specs, runs, results, other, build_s)


def drawn_bits(spec: Spec, r) -> list:
    """FL's bits of each cycle from the n_tx its sync's draws give
    (`drawn_stacked_tx` on the round's key, replayed without sending):
    the wire width x each packet's size x its n_tx, summed."""
    scheme = r.exp.scheme
    radio = scheme.radio
    sizes = np.array([leaf.numel() // scheme.n_users for leaf in
                      tree_leaves(r.exp.final_state.train.trainable[
                          "model"])], np.float64)
    out = []
    for cyc in range(len(r.reports)):
        draws = scheme.round_key(spec.seed, cyc).fold_in(
            SYNC_KEY_FOLD).draws()
        n_tx = W.drawn_stacked_tx(
            draws, scheme.n_users, len(sizes), radio.fading, radio.perfect,
            radio.arq_attempts, radio.arq_min_f2, radio.arq_max_tx,
            radio.ge_p_gb, radio.ge_p_bg)
        out.append(float(radio.wire_width()) * float((sizes * n_tx).sum()))
    return out


def path_launches(spec: Spec, device) -> tuple:
    """((K1, K3, K4) a round, an eval) the run must launch on `device`."""
    if torch.device(device).type != "cuda":
        return T2.NO_LAUNCHES
    return T2.mode_launches(spec.mode, spec.n_train, spec.n_test)


def bills(spec: Spec, r) -> tuple:
    """(init-time bits, bits of each cycle, users) the run must bill."""
    init, per, users = T2.closed_form_bits(spec.wcfg, spec.n_train)
    per_cycle = drawn_bits(spec, r) if per is None \
        else [per] * len(r.reports)
    return init, per_cycle, users


def failures(f3: Fig3Run, device) -> list:
    """What the run must meet: bills equal to their closed form, the
    path's K1 / K3 / K4 launches (none on the CPU), finite losses and
    accuracies, and no other kernel launched."""
    out = []
    for p, specs in f3.specs.items():
        for s, r in zip(specs, f3.runs[p]):
            out += T2.run_failures(s.name, r, *bills(s, r),
                                   path_launches(s, device))
            if len(r.reports) != s.cycles:
                out.append(f"{s.name}: {len(r.reports)} of {s.cycles} "
                           f"cycles")
    if f3.other_launches:
        out.append(f"kernels off the path launched: {f3.other_launches}")
    return out


def summary(f3: Fig3Run, device) -> dict:
    """panel -> each run's spec, seconds, bills, launches and scores."""
    out = {}
    for p, specs in f3.specs.items():
        out[p] = []
        for s, r in zip(specs, f3.runs[p]):
            init, per, _ = bills(s, r)
            out[p].append(dict(
                series=s.series, snr_db=s.snr_db, cycles=s.cycles,
                seed=s.seed, n_train=s.n_train, n_test=s.n_test,
                wcfg=None if s.wcfg is None else dataclasses.asdict(s.wcfg),
                s_per_cycle=r.walls, init_s=r.init_s,
                init_bits=r.init_bits, bits=[rep.bits for rep in r.reports],
                want_init_bits=init, want_bits=per,
                n_tx=[rep.n_tx for rep in r.reports],
                total_bits=r.result.total_bits,
                launches_round=r.round_launches,
                launches_eval=r.eval_launches,
                want_launches=path_launches(s, device),
                accuracy=r.result.accuracy, loss=r.result.loss))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--panels", default=",".join(PANELS),
                    help="comma-separated subset of a,b,c,d")
    ap.add_argument("--full", action="store_true",
                    help="the paper's cycles (50 / 7 / 10 / 20)")
    ap.add_argument("--cycles", type=int, default=None,
                    help="each panel's `cycles` (default: the quick or "
                    "--full count)")
    ap.add_argument("--fl-cycles", type=int, default=None,
                    help="FL's cycles in 3a / 3c / 3d (default 7 / 5 / 7)")
    ap.add_argument("--sl-cycles", type=int, default=None,
                    help="SL's cycles (default max(cycles, 35), 3c 28)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-train", type=int, default=None,
                    help="training rows (default each panel's corpus; "
                    "smaller for a CPU run)")
    ap.add_argument("--n-test", type=int, default=None)
    ap.add_argument("--out", default="", help="write the JSON here")
    args = ap.parse_args(argv)
    args.panels = [p for p in args.panels.split(",") if p]
    for p in args.panels:
        if p not in PANELS:
            ap.error(f"unknown panel {p!r} (one of {','.join(PANELS)})")
    return args


def _print_run(s: Spec, r, per: list, want: tuple) -> None:
    walls = r.walls
    steady = float(np.mean(walls[1:] or walls))
    print(f"# {s.name}: {len(walls)} cycles, s per cycle {walls[0]:.4f} "
          f"the first, mean {steady:.4f} after it (min {min(walls):.4f}, "
          f"max {max(walls):.4f}), init {r.init_s:.3f} s; bits init "
          f"{r.init_bits:.0f}, per cycle "
          f"{sorted(set(rep.bits for rep in r.reports))} (closed form "
          f"{sorted(set(per))}), total {r.result.total_bits:.0f}; n_tx per "
          f"cycle {sorted(set(rep.n_tx for rep in r.reports))}; (K1, K3, "
          f"K4) launches per round "
          f"{dict(collections.Counter(r.round_launches))}, per eval "
          f"{dict(collections.Counter(r.eval_launches))} (path {want}); "
          f"accuracy last {r.result.accuracy[-1]:.4f}, loss last "
          f"{r.result.loss[-1]:.4f}", flush=True)


def main(argv=None) -> Fig3Run:
    args = parse_args(argv)
    device, card = T2.open_device(args.device)
    print(f"# fig3 card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {device}", flush=True)
    t0 = time.perf_counter()
    f3 = run(args.panels, args.full, args.seed, cycles=args.cycles,
             fl_cycles=args.fl_cycles, sl_cycles=args.sl_cycles,
             n_train=args.n_train, n_test=args.n_test, device=device)
    wall = time.perf_counter() - t0
    print(f"# fig3 kernels built first: {f3.build_s:.2f} s", flush=True)
    printed = []
    for p, specs in f3.specs.items():
        for s, r in zip(specs, f3.runs[p]):
            _print_run(s, r, bills(s, r)[1], path_launches(s, device))
        for line in lines(p, f3.results[p]):
            print(line, flush=True)
            printed.append(line)
    print(f"# fig3 wall {wall:.1f} s on {card}", flush=True)
    bad = failures(f3, device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": str(device),
                       "args": vars(args), "results": f3.results,
                       "lines": printed, "runs": summary(f3, device),
                       "build_s": f3.build_s, "wall_s": wall,
                       "failures": bad}, f, indent=1)
    for msg in bad:
        print(f"fig3 FAILED: {msg}", file=sys.stderr, flush=True)
    if bad:
        raise SystemExit(1)
    return f3


if __name__ == "__main__":
    main()
