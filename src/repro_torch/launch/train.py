"""Training entry point for the paper's model — the `paper-tinylstm`
path of `repro/launch/train.py`:

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-tinylstm \\
        --mode fl --steps 160

runs `build_scheme(...)` + `Experiment` on the sentiment corpus at the
paper's size (24,576 training / 2,560 test rows unless `--n-train`/
`--n-test` say otherwise) with the paper's lr schedule, and prints each
cycle's loss, test accuracy and bill. `--steps` is the target TOTAL
optimizer steps per client; a CL/SL cycle is one corpus epoch, an FL
cycle J local epochs. Runs on the GPU by default and raises without one
(`--device cpu` runs the plain versions). Weights are drawn from
`--seed`. The scaled architectures, fleets and checkpointing are still
to port and raise.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.configs.base import WirelessConfig
from repro_torch.nn import resolve_device
from repro_torch.schemes import BATCH, N_TEST, N_TRAIN, Experiment, \
    build_scheme


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="cl", choices=["cl", "fl", "sl"])
    ap.add_argument("--steps", type=int, default=20,
                    help="target total optimizer steps (per client)")
    ap.add_argument("--snr-db", type=float, default=20.0)
    ap.add_argument("--quant-bits", type=int, default=8)
    ap.add_argument("--n-users", type=int, default=3, help="FL users N")
    ap.add_argument("--local-steps", type=int, default=5,
                    help="FL local epochs J")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "int8", "int4"],
                    help="FL sync codeword container (int4: two "
                         "codewords/byte, needs --quant-bits<=4)")
    ap.add_argument("--n-train", type=int, default=N_TRAIN)
    ap.add_argument("--n-test", type=int, default=N_TEST)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def build_wcfg(args):
    if args.mode == "cl":
        return None           # ideal link; the corpus crossing still bills
    if args.mode == "fl":
        return WirelessConfig(mode="fl", snr_db=args.snr_db,
                              quant_bits=args.quant_bits,
                              local_steps=args.local_steps,
                              n_users=args.n_users,
                              wire_dtype=args.wire_dtype)
    return WirelessConfig(mode="sl", snr_db=args.snr_db,
                          quant_bits=args.quant_bits)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if cfg.family != "tiny":
        raise NotImplementedError(
            f"training {args.arch!r} (family {cfg.family!r}) is not ported "
            f"yet; the port trains paper-tinylstm (see ROADMAP.md, P15)")
    device = resolve_device(args.device)
    scheme = build_scheme(build_wcfg(args), device=device)
    if args.mode == "fl":
        spc = args.local_steps * (args.n_train // args.n_users // BATCH)
    else:
        spc = args.n_train // BATCH
    cycles = max(1, math.ceil(args.steps / max(spc, 1)))
    history = []
    t0 = time.time()

    def on_cycle(cyc, acc, rep):
        dt = (time.time() - t0) / (cyc + 1)
        print(f"cycle {cyc:4d}  loss {rep.loss:.4f}  acc {acc:.3f}  "
              f"bits {rep.bits:.3e}  n_tx {rep.n_tx:.0f}  "
              f"energy {rep.energy_j:.3e} J  ({dt:.2f}s/cycle)", flush=True)
        history.append({"cycle": cyc, "loss": rep.loss, "acc": acc,
                        "bits": rep.bits})
        if not np.isfinite(rep.loss):
            raise FloatingPointError(f"loss diverged at cycle {cyc}")

    exp = Experiment(scheme, cycles=cycles, seed=args.seed,
                     n_train=args.n_train, n_test=args.n_test,
                     on_cycle=on_cycle)
    res = exp.run()
    init_bits = exp.init_delivery.bits if exp.init_delivery else 0.0
    print(f"done: {cycles} cycles on {device}, final acc "
          f"{res.final_accuracy:.3f}, total bits {res.total_bits:.3e} "
          f"(init {init_bits:.3e}), "
          f"energy {sum(r.energy_j for r in exp.reports):.3e} J")
    return {"history": history, "final_loss": history[-1]["loss"],
            "result": res,
            "experiment": exp}


if __name__ == "__main__":
    main()
