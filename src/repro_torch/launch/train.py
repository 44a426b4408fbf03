"""Training entry point — the port of `repro/launch/train.py`, for the
paper's model and every scaled family (dense, MoE, VLM, SSM, hybrid,
audio):

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-tinylstm \\
        --mode fl --steps 160
    # qwen1.5-0.5b at full width through the scaled FL cycle, K2 sync
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --mode fl --steps 5 --use-kernel
    # the MoE family at its reduced size (2 layers, 4 experts top-2)
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-moe-235b-a22b --reduced --mode sl --steps 2
    # xLSTM at full width and depth (24 layers: 4 super-blocks), FL
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --mode fl --steps 2 --local-steps 2
    # the VLM at its reduced size (2 layers, 16 patch tokens)
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internvl2-76b --reduced --mode cl --steps 2
    # the hybrid (Mamba2 + shared attention) and the enc-dec at full
    # width, SL (cut at super-block 2 / at the encoder output)
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --mode sl --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-medium --mode sl --steps 2
    # a 10,000-client synthetic fleet, 3 rounds (the billing plane)
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-tinylstm \\
        --fleet-size 10000 --fleet-sl-frac 0.3 --fleet-sample 0 --steps 3
    # snapshot every cycle; a rerun with the same --ckpt-dir resumes
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-tinylstm \\
        --mode fl --steps 320 --ckpt-dir ck --ckpt-every 1

runs `build_scheme(...)` + `Experiment` on the sentiment corpus at the
paper's size (24,576 training / 2,560 test rows unless `--n-train`/
`--n-test` say otherwise) with the paper's lr schedule, and prints each
cycle's loss, test accuracy and bill (every `--log-every` cycles, and
the last). `--steps` is the target TOTAL
optimizer steps per client; a CL/SL cycle is one corpus epoch, an FL
cycle J local epochs, a fleet round one cycle per step.

`--fleet-size N` runs an N-client fleet instead of the single-link
schemes: `--fleet-engine synthetic` (default) a `ClientBatch` with no
per-client Python objects (the billing plane, 10^5 clients and more),
`loop` the per-client `PopulationScheme`, `fleet` the struct-of-arrays
`FleetScheme` on the same specs (bills equal to the loop's), `auto` the
loop; `--fleet-sl-frac` of the clients run SL, `--fleet-sample k`
samples k clients a round (0 = all). Fleet rounds print their status
counts. `--ckpt-dir` snapshots the whole run every `--ckpt-every`
cycles (checkpoint/ckpt.py) and, when the directory already holds a
snapshot, resumes from the latest one, bit for bit.

Any other registered arch (`--reduced` for its smoke-scale variant; a
VLM batch adds stub patch embeddings, an audio batch stub frames) runs the scaled schemes (schemes/scaled.py) on a
synthetic Zipf LM corpus (512 / 128 rows unless `--n-train`/`--n-test`
say otherwise) at a constant `--lr` (3e-4): a CL/SL cycle is
`--cycle-steps` optimizer steps (AdamW unless `--optimizer sgd`), an FL
cycle `--local-steps` SGD-momentum steps per user and one sync
(`--sync barrier|delayed`, `--use-kernel` for K2's fused mean).

`--mesh test` builds the scheme and runs every round under the test
mesh (launch/mesh.py: all ones on one card, so every logical axis
resolves to replication and the run is `--mesh none`'s, bit for bit).
`--aot-warmup` builds and loads the kernel libraries the rounds launch
before the first cycle and prints `aot_warmup_compile_wall_s=`; the
libraries live in the kernel-build cache (launch/compile_cache.py:
`$REPRO_TORCH_KERNEL_CACHE_DIR` or build/kernels/), so a second process
reports a near-zero wall. `--no-compile-cache` builds into a fresh
temporary directory instead, so the process pays `nvcc`.

Runs on the GPU by default and raises without one (`--device cpu` runs
the plain versions). Weights are drawn from `--seed`. `--report-json`
writes every cycle's bill, loss and accuracy at full precision and each
kernel's launches over the run.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from repro_torch.checkpoint.ckpt import latest_experiment_cycle
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig, WirelessConfig
from repro_torch.kernels import launch_counts
from repro_torch.launch import compile_cache
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.nn import resolve_device, use_mesh
from repro_torch.schemes import (BATCH, N_TEST, N_TRAIN, ClientBatch,
                                 ClientSpec, Experiment,
                                 ParticipationPolicy, build_scheme, corpus)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="cl", choices=["cl", "fl", "sl"])
    ap.add_argument("--steps", type=int, default=20,
                    help="target total optimizer steps (per client)")
    ap.add_argument("--cycle-steps", type=int, default=5,
                    help="scaled CL/SL: optimizer steps per cycle")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--optimizer", default=None, choices=["adamw", "sgd"],
                    help="scaled cl/sl optimizer (default adamw); the "
                         "FL cycle and the paper schemes are "
                         "SGD-momentum by construction")
    ap.add_argument("--lr", type=float, default=None,
                    help="constant lr (default: 3e-4 scaled; the paper "
                         "schedule for paper-tinylstm)")
    ap.add_argument("--split-layer", type=int, default=2)
    ap.add_argument("--sync", default="barrier",
                    choices=["barrier", "delayed"],
                    help="FL cycle scheduling: barrier (paper) or "
                         "delayed (one cycle of staleness)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="FL: quantize -> channel -> dequantize -> mean "
                         "in one launch (K2)")
    ap.add_argument("--snr-db", type=float, default=20.0)
    ap.add_argument("--quant-bits", type=int, default=8)
    ap.add_argument("--n-users", type=int, default=3, help="FL users N")
    ap.add_argument("--local-steps", type=int, default=5,
                    help="FL local epochs J")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "int8", "int4"],
                    help="FL sync codeword container (int4: two "
                         "codewords/byte, needs --quant-bits<=4)")
    ap.add_argument("--fleet-size", type=int, default=0,
                    help="run an N-client fleet of the paper's model "
                         "instead of the single-link schemes (one cycle "
                         "per --steps step)")
    ap.add_argument("--fleet-engine", default="synthetic",
                    choices=["auto", "loop", "fleet", "synthetic"],
                    help="loop = per-client PopulationScheme, fleet = "
                         "FleetScheme on the same specs (bills equal to "
                         "loop), synthetic = a ClientBatch with no "
                         "per-client Python objects, auto = loop")
    ap.add_argument("--fleet-sl-frac", type=float, default=0.0,
                    help="fraction of fleet clients on the SL paradigm")
    ap.add_argument("--fleet-sample", type=int, default=8,
                    help="uniform-k participation per round (0 = all)")
    ap.add_argument("--n-train", type=int, default=0,
                    help=f"corpus rows (0 = {N_TRAIN} tiny / 512 scaled)")
    ap.add_argument("--n-test", type=int, default=0,
                    help=f"held-out rows (0 = {N_TEST} tiny / 128 scaled)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="checkpoint every k cycles")
    ap.add_argument("--log-every", type=int, default=1,
                    help="print every k cycles")
    ap.add_argument("--mesh", default="none", choices=["none", "test"],
                    help="test: build and run under the test mesh (all "
                         "ones on one card)")
    ap.add_argument("--aot-warmup", action="store_true",
                    help="build and load the kernels the rounds launch "
                         "before the first cycle and print "
                         "aot_warmup_compile_wall_s= (near zero when the "
                         "kernel-build cache holds them)")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="build the kernels into a fresh temporary "
                         "directory instead of the kernel-build cache "
                         "(launch/compile_cache.py)")
    ap.add_argument("--report-json", default="",
                    help="also write every cycle's bill, loss and accuracy "
                         "(full precision) and the kernel launches as JSON "
                         "to this file")
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
                              n_users=args.n_users, sync=args.sync,
                              wire_dtype=args.wire_dtype,
                              use_kernel=args.use_kernel)
    return WirelessConfig(mode="sl", snr_db=args.snr_db,
                          quant_bits=args.quant_bits,
                          split_layer=args.split_layer)


def build_fleet(args, device, data):
    """The `--fleet-*` fleet: a synthetic ClientBatch, or loop-expressible
    specs that share one batch-sized shard (so the corpus bounds the
    shard, not the fleet size), the first `--fleet-sl-frac` of them SL."""
    kwargs = {}
    if args.fleet_sample > 0:
        kwargs["policy"] = ParticipationPolicy.uniform(
            min(args.fleet_sample, args.fleet_size))
    base = WirelessConfig(mode="fl", snr_db=args.snr_db,
                          quant_bits=args.quant_bits)
    if args.fleet_engine == "synthetic":
        batch = ClientBatch.synthetic(args.fleet_size, seed=args.seed,
                                      quant_bits=args.quant_bits,
                                      sl_frac=args.fleet_sl_frac)
        return build_scheme(base, clients=batch, device=device, **kwargs)
    (xtr, ytr), _ = data
    shard = (xtr[:BATCH], ytr[:BATCH])
    n_sl = int(round(args.fleet_size * args.fleet_sl_frac))
    specs = [(ClientSpec.sl(base, shard=shard, quant_bits=16,
                            name=f"sl{i}") if i < n_sl else
              ClientSpec.fl(base, shard=shard, name=f"fl{i}"))
             for i in range(args.fleet_size)]
    return build_scheme(base, clients=specs, engine=args.fleet_engine,
                        device=device, **kwargs)


def build_scaled(args, cfg, device):
    """The scaled scheme of `--mode` at `--batch` x `--seq`, and its
    optimizer steps per cycle (per user for FL)."""
    shape = ShapeConfig("cli", args.seq, args.batch, "train",
                        microbatch=args.batch)
    if args.mode == "fl":
        if args.optimizer not in (None, "sgd"):
            raise SystemExit(f"--mode fl runs SGD-momentum local steps; "
                             f"--optimizer {args.optimizer} is not "
                             f"supported")
        kwargs = {}
    else:
        kwargs = {"optimizer": args.optimizer or "adamw"}
    scheme = build_scheme(build_wcfg(args), cfg=cfg, shape=shape,
                          steps_per_cycle=args.cycle_steps, device=device,
                          **kwargs)
    return scheme, (args.local_steps if args.mode == "fl"
                    else args.cycle_steps)


def main(argv=None) -> dict:
    args = parse_args(argv)
    compile_cache.use_kernel_cache(args.no_compile_cache)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tiny = cfg.family == "tiny"
    device = resolve_device(args.device)
    mesh = make_test_mesh() if args.mesh == "test" else None
    launched0 = launch_counts()
    args.n_train = args.n_train or (N_TRAIN if tiny else 512)
    args.n_test = args.n_test or (N_TEST if tiny else 128)
    lr_schedule = (lambda e: args.lr) if args.lr is not None else None
    data = None
    with use_mesh(mesh):
        if not tiny:
            if args.fleet_size > 0:
                raise SystemExit("--fleet-size runs the paper's tiny "
                                 "model; use --arch paper-tinylstm")
            scheme, spc = build_scaled(args, cfg, device)
        else:
            data = corpus(args.n_train, args.n_test, args.seed)
            if args.fleet_size > 0:
                scheme = build_fleet(args, device, data)
                spc = 1              # one communication cycle per step
            else:
                scheme = build_scheme(build_wcfg(args), device=device)
                if args.mode == "fl":
                    spc = args.local_steps * (args.n_train // args.n_users
                                              // BATCH)
                else:
                    spc = args.n_train // BATCH
    cycles = max(1, math.ceil(args.steps / max(spc, 1)))

    if args.aot_warmup:
        with use_mesh(mesh):
            wall = compile_cache.warmup(scheme)
        print(f"aot_warmup_compile_wall_s={wall:.6f}", flush=True)
    history = []
    t0 = time.time()

    def on_cycle(cyc, acc, rep):
        if cyc % args.log_every and cyc != cycles - 1:
            return
        dt = (time.time() - t0) / (cyc + 1)
        extra = ""
        if "fleet" in rep.metrics:   # streamed fleet summaries
            counts = rep.metrics["fleet"]["status_counts"]
            extra = "  [" + " ".join(
                f"{k}={v}" for k, v in sorted(counts.items())) + "]"
        print(f"cycle {cyc:4d}  loss {rep.loss:.4f}  acc {acc:.3f}  "
              f"bits {rep.bits:.3e}  n_tx {rep.n_tx:.0f}  "
              f"energy {rep.energy_j:.3e} J  ({dt:.2f}s/cycle){extra}",
              flush=True)
        history.append({"cycle": cyc, "loss": rep.loss, "acc": acc,
                        "bits": rep.bits})
        if not np.isfinite(rep.loss):
            raise FloatingPointError(f"loss diverged at cycle {cyc}")

    resume = None
    if args.ckpt_dir and latest_experiment_cycle(args.ckpt_dir) is not None:
        resume = args.ckpt_dir
        print(f"resuming from cycle "
              f"{latest_experiment_cycle(args.ckpt_dir)} "
              f"({os.path.abspath(args.ckpt_dir)})", flush=True)
    with use_mesh(mesh):
        exp = Experiment(scheme, cycles=cycles, seed=args.seed,
                         n_train=args.n_train, n_test=args.n_test,
                         data=data, lr_schedule=lr_schedule,
                         on_cycle=on_cycle,
                         checkpoint_dir=args.ckpt_dir or None,
                         checkpoint_every=(args.ckpt_every if args.ckpt_dir
                                           else 0),
                         resume_from=resume)
        res = exp.run()
    if args.report_json:
        launched = {k: n - launched0[k]
                    for k, n in launch_counts().items()}
        with open(args.report_json, "w") as f:
            json.dump({"reports": [
                {k: getattr(r, k) for k in ("loss", "steps", "bits", "n_tx",
                                            "energy_j", "erased_bits")}
                for r in exp.reports], "accuracy": res.accuracy,
                "kernel_launches": launched, "device": str(device)}, f)
    init_bits = exp.init_delivery.bits if exp.init_delivery else 0.0
    print(f"done: {cycles} cycles on {device}, final acc "
          f"{res.final_accuracy:.3f}, total bits {res.total_bits:.3e} "
          f"(init {init_bits:.3e}), "
          f"energy {sum(r.energy_j for r in exp.reports):.3e} J")
    final_loss = (history[-1]["loss"] if history
                  else (res.loss[-1] if res.loss else 0.0))
    return {"history": history, "final_loss": final_loss, "result": res,
            "experiment": exp}


if __name__ == "__main__":
    main()
