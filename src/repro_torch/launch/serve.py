"""Serving entry point: many users over the semantic link, billed per user —
the engine path of `repro/launch/serve.py`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 24 --snr-db 10 --greedy

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch paper-tinylstm --prompt-len 30 --new-tokens 1 --greedy

    # the MoE family (--reduced: 2 layers, d_model 256, 4 experts top-2)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-235b-a22b --reduced --device cpu --greedy

    # xLSTM (no per-slot decode path: the billed static loop)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
        --batch 4 --prompt-len 32 --new-tokens 16 --snr-db 10 --greedy

    # the hybrid (zamba2-1.2b) and the enc-dec (seamless-m4t-medium) at
    # their reduced size on the CPU (the static loop as well)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --reduced --device cpu --greedy

Runs on the GPU by default (`--device cpu` for the plain versions, at
`--reduced` size for the transformer). Weights are random, drawn from
`--seed`. The paper's tiny classifier answers each prompt with its
sentiment class (one generated token in {0, 1} per step). Families
without a per-slot decode path (ssm, hybrid, audio) run `legacy_main`:
one static batch, token by token, its prompt batch billed on one uplink
and its generated tokens on one downlink through the same Radio (an
audio batch first encodes stub frames, 0.1 everywhere, into its
cross-attention cache, as the JAX package does); a family with no
decode step at all exits.

`--mesh test` builds the engine and serves under the test mesh (all ones
on one card: every logical axis resolves to replication, so tokens and
bills are `--mesh none`'s). `--aot-warmup` builds the kernels and runs
the decode step and every prefill bucket once before admitting
requests (`ServeEngine.warmup_compile`) and prints
`aot_warmup_compile_wall_s=`; the kernel libraries come from the
kernel-build cache (launch/compile_cache.py), or from a fresh temporary
directory under `--no-compile-cache`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.draws import seeded
from repro_torch.launch import compile_cache
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api as M
from repro_torch.models import encdec
from repro_torch.nn import init_params, init_tree, resolve_device, use_mesh
from repro_torch.runtime.train_step import window_for
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
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (engine) / batch rows (static loop)")
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
    ap.add_argument("--mesh", default="none", choices=["none", "test"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--aot-warmup", action="store_true",
                    help="build the kernels and run the decode step and "
                         "every prefill bucket once before admitting "
                         "requests; prints aot_warmup_compile_wall_s=")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="build the kernels into a fresh temporary "
                         "directory instead of the kernel-build cache "
                         "(launch/compile_cache.py)")
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


# ------------------------------------------------ the static loop
# streams of the static loop, as the JAX package folds PRNGKey(seed):
# prompt ids, the first token's sampling (then 3 + j for token j), the
# prompt uplink and the token downlink
PROMPT, SAMPLE0, UPLINK, DOWNLINK = 1, 2, 4, 5


class LegacyDraws:
    """The static loop's random draws, one seeded torch stream per fold
    of the seed (the JAX package's `jax.random.fold_in(key, fold)`): a
    test hands in the JAX package's own numbers instead."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def prompt(self, shape, vocab: int) -> torch.Tensor:
        """Prompt ids [B, P] int32 in [1, vocab)."""
        g = seeded(self.seed, PROMPT).generator
        return torch.randint(1, vocab, tuple(shape), generator=g,
                             dtype=torch.int64).to(torch.int32)

    def link(self, fold: int):
        """Channel `Draws` of one crossing (UPLINK or DOWNLINK)."""
        return seeded(self.seed, fold)

    def gumbel(self, fold: int, shape) -> torch.Tensor:
        """Gumbel noise [B, V] f32 for one sampling step."""
        g = seeded(self.seed, fold).generator
        u = torch.rand(tuple(shape), generator=g).clamp_min(1e-20)
        return -torch.log(-torch.log(u))


def sample(lg: torch.Tensor, noise, temperature: float,
           greedy: bool) -> torch.Tensor:
    """[B] next ids from logits [B, V]: argmax when greedy (or T <= 0),
    else argmax(lg / T + Gumbel) — jax.random.categorical's rule;
    `noise` () -> the Gumbel draw, called only when sampling."""
    if not greedy and temperature > 0:
        lg = lg / temperature + noise().to(lg.device, lg.dtype)
    return lg.argmax(dim=-1).to(torch.int32)


def legacy_main(args, cfg, device) -> dict:
    """Single static batch, token by token: the decode path of families
    without a per-slot index (ssm, hybrid, audio). Weights drawn from
    `--seed`."""
    if M.get_model(cfg).decode_step is None:
        raise SystemExit(f"{args.arch} has no decode step (encoder-only)")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_tree(M.param_specs(cfg), gen, device)
    return legacy_loop(args, cfg, params, device)


def legacy_loop(args, cfg, params, device, draws=None) -> dict:
    """The static loop on given weights: the prompt batch [batch,
    prompt_len] crosses ONE uplink (`Radio.send_tokens`) before the
    server sees it, the model decodes the received prompt one position
    at a time and then `new_tokens` more, and the generated ids return
    on ONE downlink. Returns the generated ids [B, N], the received
    prompt, the logits of every prompt position [B, P, V] (f32), the
    seconds of the prompt and the generation, and the bill (bits, erased
    bits, energy)."""
    model = M.get_model(cfg)
    if model.decode_step is None:
        raise SystemExit(f"{args.arch} has no decode step (encoder-only)")
    draws = draws or LegacyDraws(args.seed)
    B, P, N = args.batch, args.prompt_len, args.new_tokens
    shape = ShapeConfig("serve", P + N, B, "decode")
    window = window_for(cfg, shape)
    radio = make_radio(args)
    bits = energy = erased = 0.0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cache = model.init_cache(cfg, B, P + N, device)
    if cfg.family == "audio":
        frames = 0.1 * torch.ones((B, encdec.src_len(cfg, P + N),
                                   cfg.d_model), device=device)
        with torch.inference_mode():
            cache = encdec.prefill_cross(params, frames, cfg, cache)
    prompt = draws.prompt((B, P), cfg.vocab_size)
    # uplink: the users' prompts cross the radio BEFORE the server sees
    # them; the server decodes what was received
    d = radio.send_tokens(draws.link(UPLINK), prompt, cfg.vocab_size)
    bits += d.bits
    energy += d.energy_j
    erased += d.erased_bits
    prompt = torch.as_tensor(d.payload).to(device)
    out, prompt_logits = [], []
    with torch.inference_mode():
        t0 = time.perf_counter()
        for i in range(P):
            logits, cache = model.decode_step(params, cache,
                                              prompt[:, i:i + 1], i, cfg,
                                              window)
            prompt_logits.append(logits[:, 0].float())
        sync()
        t_prefill = time.perf_counter() - t0
        V = logits.shape[-1]
        tok = sample(logits[:, 0], lambda: draws.gumbel(SAMPLE0, (B, V)),
                     args.temperature, args.greedy)[:, None]
        t0 = time.perf_counter()
        for j in range(N):
            out.append(tok)
            logits, cache = model.decode_step(params, cache, tok, P + j,
                                              cfg, window)
            tok = sample(logits[:, 0],
                         lambda j=j: draws.gumbel(SAMPLE0 + 1 + j, (B, V)),
                         args.temperature, args.greedy)[:, None]
        sync()
        t_decode = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu()
    # downlink: the generated ids return to the users over the same radio
    d = radio.send_tokens(draws.link(DOWNLINK), gen, cfg.vocab_size)
    bits += d.bits
    energy += d.energy_j
    erased += d.erased_bits
    print(f"static loop on {device}: prefill {P} toks: {t_prefill:.2f}s | "
          f"decode {N} toks: {t_decode:.2f}s "
          f"({t_decode / max(N, 1) * 1e3:.1f} ms/tok)")
    print(f"radio: {bits:.0f} bits ({erased:.0f} erased), "
          f"{energy * 1e3:.3f} mJ")
    if gen.shape != (B, N) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError("static loop: wrong shape or non-finite logits")
    return {"generated": gen.numpy().astype(np.int32),
            "prompt": prompt.cpu().numpy(),
            "prompt_logits": torch.stack(prompt_logits, 1),
            "t_prefill_s": t_prefill, "t_decode_s": t_decode,
            "bits": bits, "erased_bits": erased, "energy_j": energy}


def main(argv=None) -> dict:
    args = parse_args(argv)
    compile_cache.use_kernel_cache(args.no_compile_cache)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_test_mesh() if args.mesh == "test" else None
    if cfg.family not in SLOT_FAMILIES:
        print(f"{cfg.family}: scalar-index decode only — static loop")
        with use_mesh(mesh):
            return legacy_main(args, cfg, dev)
    radio = make_radio(args)
    trace = resolve_trace(args, args.snr_db if args.snr_db is not None
                          else 20.0)
    with use_mesh(mesh):
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        params = init_params(M.param_specs(cfg), gen, dev)
        engine = ServeEngine(cfg, params, n_slots=args.batch, radio=radio,
                             temperature=args.temperature,
                             greedy=args.greedy, prefill=args.prefill,
                             kv=args.kv, chunk_size=args.chunk_size,
                             page_size=args.page_size,
                             page_budget=args.page_budget, device=dev)
        if args.aot_warmup:
            wall = engine.warmup_compile(trace.max_seq_len())
            print(f"aot_warmup_compile_wall_s={wall:.6f}", flush=True)
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
