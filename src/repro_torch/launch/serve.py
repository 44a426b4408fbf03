"""Serving entry point: many users over the semantic link, billed per user —
the engine path of `repro/launch/serve.py`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 24 --snr-db 10 --greedy

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch paper-tinylstm --prompt-len 30 --new-tokens 1 --greedy

    # the MoE family (--reduced: 2 layers, d_model 256, 4 experts top-2)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-235b-a22b --reduced --device cpu --greedy

Runs on the GPU by default (`--device cpu` for the plain versions, at
`--reduced` size for the transformer). Weights are random, drawn from
`--seed`. The paper's tiny classifier answers each prompt with its
sentiment class (one generated token in {0, 1} per step). Families
without a per-slot decode path are not ported yet and raise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import api as M
from repro_torch.nn import init_params, resolve_device
from repro_torch.schemes.radio import Radio
from repro_torch.serve import (RequestTrace, ServeEngine, SLOT_FAMILIES,
                               make_trace, uniform_trace)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=0,
                    help=">0: synthetic arrival trace of this many "
                         "requests instead of the uniform demo trace")
    ap.add_argument("--trace", default=None,
                    help="replay a RequestTrace JSON file")
    ap.add_argument("--snr-db", type=float, default=None,
                    help="base link SNR; omit for an ideal noiseless "
                         "link (still billed)")
    ap.add_argument("--arq-max-tx", type=int, default=0,
                    help=">0: bounded ARQ — exhausted uplinks are "
                         "erased and the request abandoned")
    ap.add_argument("--prefill", default="chunked",
                    choices=["chunked", "token"])
    ap.add_argument("--kv", default="paged", choices=["paged", "dense"])
    ap.add_argument("--chunk-size", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--page-budget", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and run the decode step and "
                         "every prefill bucket once before serving; "
                         "prints warmup_wall_s=")
    return ap.parse_args(argv)


def make_radio(args) -> Radio:
    if args.snr_db is None:
        return Radio(perfect=True, fading=False,
                     arq_max_tx=args.arq_max_tx)
    return Radio(snr_db=args.snr_db, fading=True,
                 arq_max_tx=args.arq_max_tx,
                 arq_attempts=2 if args.arq_max_tx else 1)


def resolve_trace(args, snr_db: float) -> RequestTrace:
    if args.trace:
        return RequestTrace.load(args.trace)
    if args.requests > 0:
        return make_trace(args.seed, args.requests)
    return uniform_trace(args.seed, args.batch, args.prompt_len,
                         args.new_tokens, snr_db)


def gen_matrix(report, n_new: int) -> np.ndarray:
    """Per-request generated ids as a padded [n_requests, n_new] matrix."""
    gen = np.zeros((len(report.results), n_new), np.int32)
    for i, r in enumerate(report.results):
        row = np.asarray(r.tokens[:n_new], np.int32)
        gen[i, :len(row)] = row
    return gen


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family not in SLOT_FAMILIES:
        raise NotImplementedError(
            f"{cfg.family}: no per-slot decode path in the port yet "
            f"(see ROADMAP.md, P15)")
    radio = make_radio(args)
    trace = resolve_trace(args, args.snr_db if args.snr_db is not None
                          else 20.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(M.param_specs(cfg), gen, dev)
    engine = ServeEngine(cfg, params, n_slots=args.batch, radio=radio,
                         temperature=args.temperature, greedy=args.greedy,
                         prefill=args.prefill, kv=args.kv,
                         chunk_size=args.chunk_size,
                         page_size=args.page_size,
                         page_budget=args.page_budget, device=dev)
    if args.warmup:
        print(f"warmup_wall_s={engine.warmup_compile(trace.max_seq_len())}",
              flush=True)
    report = engine.serve(trace, args.engine)

    d = report.to_dict()
    print(f"{args.engine} on {dev}: {trace.n_requests} requests on "
          f"{args.batch} slots -> {d['cycles']} cycles, "
          f"{d['generated_tokens']} tokens "
          f"({d['tokens_per_s']:.1f} tok/s) | statuses {d['statuses']}")
    print(f"latency p50 {d['p50_latency_cycles']:.0f} / "
          f"p99 {d['p99_latency_cycles']:.0f} cycles | ttft p50 "
          f"{d['p50_ttft_cycles']:.0f} / p99 {d['p99_ttft_cycles']:.0f} "
          f"cycles, {d['p50_ttft_s']} / {d['p99_ttft_s']} s | radio "
          f"{d['bits']:.0f} bits ({d['erased_bits']:.0f} erased), "
          f"{d['energy_j'] * 1e3:.3f} mJ")
    if d["kv"] == "paged":
        print(f"paged kv: {d['peak_pages']}/{d['n_pages']} peak pages "
              f"({args.page_size} tokens each)")
    if abs(d["delivered_bits"] + d["erased_bits"] - d["bits"]) >= 1e-6:
        raise RuntimeError("bill does not add up")
    return {"generated": gen_matrix(report, args.new_tokens),
            "report": d, "results": report.results}


if __name__ == "__main__":
    main()
