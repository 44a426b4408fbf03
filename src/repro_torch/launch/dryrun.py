"""Dry run — the port of `repro/launch/dryrun.py`: ready every
(architecture x input shape x mesh) step without running it, and record
each device's argument / output bytes and the step's FLOPs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh card --mode sl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --shape train_4k

Train shapes ready the step the `Experiment` trains: the scheme that
`build_scheme(wcfg, cfg=..., shape=...)` builds, through its
`lower_step(mesh, n_data_shards=data x pod)` (schemes/scaled.py).
`--mode fl` readies the whole FL cycle with the user axis on `pod`.
Prefill and decode shapes ready the port's prefill step (the forward's
last-token logits) and decode step (one token against a seq_len cache)
on meta tensors. Nothing is allocated and nothing runs on a device:
every tensor is a meta tensor, so a 104B-parameter config at
`train_4k` is sized on any machine.

Meshes: `card` is the one-card mesh (all ones, every leaf whole), `pod`
and `multipod` the JAX package's 16 x 16 and 2 x 16 x 16 production
shapes as device-less descriptors (launch/mesh.py's `abstract_mesh`):
each leaf's share is its bytes over the mesh axes its logical axes
resolve to (nn/sharding.py). FLOPs are the whole program's matmul FLOPs
(`FlopCounterMode` on meta tensors), the count the JAX package's dry
run takes from the compiled HLO (launch/hlo_analysis.py's `dot_flops`,
trip-count-scaled), for one card running all of it: without a
partitioner nothing splits them per device. `collectives` and
`collective_bytes` are null for the same reason, `compile_s`,
`xla_cost_flops`, `xla_bytes_accessed` and `hlo_lines` because nothing
compiles the eager program; the record's `null_because` says so.

Results land in build/dryrun/<arch>_<shape>_<mesh>[_tag].json, one file
per combination, written as each finishes; a failed combination records
its error and the run goes on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_arch
from repro_torch.configs.base import WirelessConfig
from repro_torch.launch.mesh import Mesh, abstract_mesh
from repro_torch.models import api as M
from repro_torch.nn import axes_tree, shapes_tree, use_mesh
from repro_torch.runtime.serve_step import cache_specs
from repro_torch.runtime.train_step import (Lowered, key_sds,
                                            make_prefill_step,
                                            train_state_axes,
                                            train_state_sds, window_for)
from repro_torch.schemes import build_scheme

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
CARD = Mesh(("data", "model"), (1, 1))
MESHES = {"card": CARD, "16x16": abstract_mesh(),
          "2x16x16": abstract_mesh(multi_pod=True)}
NULL_BECAUSE = {
    "collectives": "no SPMD partitioner: the port runs one eager program "
                   "on one card, so no collective is inserted",
    "compile_s": "nothing compiles: the step is the eager program",
    "xla_cost_flops": "no XLA; `flops` is the FlopCounterMode count",
}


def _flop_count(fn):
    """The matmul FLOPs of `fn()` on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    def count():
        with FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops()
    return count


def dryrun_one(arch: str, shape_name: str, multi_pod, mode: str = "cl",
               out_dir=RESULTS_DIR, tag: str = "", microbatch: int = 0,
               sync: str = "barrier", reduced: bool = False) -> dict:
    """Ready one combination and write its record. `multi_pod`: False
    the 16 x 16 mesh, True 2 x 16 x 16, None the one-card mesh;
    `reduced` readies the arch's smoke-scale variant."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    shape_cfg = SHAPES[shape_name]
    if microbatch:
        shape_cfg = dataclasses.replace(shape_cfg, microbatch=microbatch)
    name = {None: "card", False: "16x16", True: "2x16x16"}[multi_pod]
    mesh = MESHES[name]
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": name,
        "n_chips": mesh.size, "mode": mode, "tag": tag, "sync": sync,
        "reduced": reduced,
    }
    t0 = time.perf_counter()
    try:
        with use_mesh(mesh):
            if shape_cfg.kind == "train":
                lowered = _lower_train(cfg, shape_cfg, mesh, mode, sync)
            elif shape_cfg.kind == "prefill":
                lowered = _lower_prefill(cfg, shape_cfg, mesh, mode)
            else:
                lowered = _lower_decode(cfg, shape_cfg, mesh)
            t1 = time.perf_counter()
            mem = lowered.memory_analysis()
            flops = lowered.cost_analysis()["flops"]
            t2 = time.perf_counter()
        record["lower_s"] = round(t1 - t0, 2)
        record["count_s"] = round(t2 - t1, 2)
        record["compile_s"] = None
        record["memory"] = {
            k: getattr(mem, k) for k in
            ("temp_size_in_bytes", "argument_size_in_bytes",
             "output_size_in_bytes", "alias_size_in_bytes",
             "generated_code_size_in_bytes")}
        record["xla_cost_flops"] = None
        record["xla_bytes_accessed"] = None
        record["flops"] = flops
        record["flops_scope"] = "the whole program, on one card"
        record["collectives"] = None
        record["collective_bytes"] = None
        record["hlo_lines"] = None
        record["null_because"] = NULL_BECAUSE
        record["ok"] = True
    except Exception as e:  # noqa: BLE001 - record and continue
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}_{shape_name}_{name}" + (f"_{tag}" if tag else "")
    with open(os.path.join(out_dir, fname.replace("/", "-") + ".json"),
              "w") as f:
        json.dump(record, f, indent=1)
    return record


def _wcfg_for(mode: str, mesh, sync: str = "barrier"):
    """The link config per mode: CL has no radio in the step; FL's user
    count is the mesh's pod extent (at least 2); SL the default link."""
    if mode == "cl":
        return None
    if mode == "fl":
        return WirelessConfig(mode="fl", sync=sync,
                              n_users=max(mesh.shape.get("pod", 1), 2))
    return WirelessConfig(mode="sl")


def _lower_train(cfg, shape_cfg, mesh, mode, sync: str = "barrier"):
    n_data = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    if cfg.family == "tiny":
        raise ValueError("the paper model trains through the tiny "
                         "schemes, whose step takes [B] class labels; the "
                         "dry run readies the scaled archs")
    scheme = build_scheme(_wcfg_for(mode, mesh, sync), cfg=cfg,
                          shape=shape_cfg, device="cpu")
    return scheme.lower_step(mesh, n_data_shards=n_data)


def _lower_prefill(cfg, shape_cfg, mesh, mode):
    """The forward on the trainable params (FL: the plain forward)."""
    wcfg = _wcfg_for(mode, mesh) if mode == "sl" else None
    trainable = train_state_sds(cfg, wcfg).trainable
    tax = train_state_axes(cfg, wcfg).trainable
    batch = M.input_sds(cfg, shape_cfg)
    bax = M.input_axes(cfg, shape_cfg)
    step = make_prefill_step(cfg, shape_cfg, wcfg)
    logits = torch.empty((shape_cfg.global_batch, cfg.vocab_size),
                         dtype=cfg.dtype, device="meta")
    return Lowered(step, (trainable, batch), (tax, bax), (logits,),
                   (("batch", "vocab"),), mesh,
                   _flop_count(lambda: step(trainable, batch, key_sds())),
                   donate=())


def _lower_decode(cfg, shape_cfg, mesh):
    """One token against a seq_len cache (donated) on the serving
    params."""
    specs = M.param_specs(cfg)
    params, pax = shapes_tree(specs), axes_tree(specs)
    cache, cax = cache_specs(cfg, shape_cfg)
    B = shape_cfg.global_batch
    token = torch.empty((B, 1), dtype=torch.int32, device="meta")
    # the transformer decodes a per-slot index vector, the recurrent and
    # enc-dec families one position for the whole batch
    index = (torch.empty((B,), dtype=torch.int32, device="meta")
             if cfg.family in ("dense", "moe", "vlm") else 0)
    model, window = M.get_model(cfg), window_for(cfg, shape_cfg)

    def step(params, cache, token, index):
        return model.decode_step(params, cache, token, index, cfg, window)
    logits = torch.empty((B, 1, cfg.vocab_size), dtype=cfg.dtype,
                         device="meta")
    return Lowered(step, (params, cache, {"token": token}),
                   (pax, cax, {"token": ("batch", None)}),
                   (logits, cache), (("batch", None, "vocab"), cax), mesh,
                   _flop_count(lambda: step(params, cache, token, index)),
                   donate=(1,))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both", "card"],
                    help="card: the one-card mesh; pod / multipod: the "
                         "16x16 / 2x16x16 production shapes; both: pod "
                         "and multipod")
    ap.add_argument("--mode", default="cl", choices=["cl", "fl", "sl"])
    ap.add_argument("--sync", default="barrier",
                    choices=["barrier", "delayed"],
                    help="FL round schedule to ready")
    ap.add_argument("--all", action="store_true",
                    help="every assigned arch (the default without --arch)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="microbatch SIZE override (0 = auto)")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' smoke-scale variants")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod": [False], "multipod": [True], "both": [False, True],
              "card": [None]}[args.mesh]
    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = dryrun_one(arch, shape, mp, mode=args.mode,
                               out_dir=args.out, tag=args.tag,
                               microbatch=args.microbatch, sync=args.sync,
                               reduced=args.reduced)
                records.append(r)
                status = "OK " if r.get("ok") else "FAIL"
                arg = r.get("memory", {}).get("argument_size_in_bytes", 0)
                print(f"[{status}] {arch:24s} {shape:12s} {r['mesh']:8s} "
                      f"args/device={arg / 2**30:.4f} GiB "
                      f"flops={r.get('flops', 0):.6e} "
                      f"err={r.get('error', '')[:120]}", flush=True)
    return records


if __name__ == "__main__":
    main()
