"""End-to-end driver of the PyTorch port: train a ~100M-parameter dense
transformer (12 layers x d_model 512 over the qwen1.5 family) for a few
hundred steps on the synthetic LM corpus through `build_scheme` +
`Experiment` (the scaled CL scheme, AdamW), asserting that the loss
drops — the port's counterpart of examples/train_100m.py.

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 200]
"""
import argparse
import dataclasses
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.schemes import Experiment, build_scheme


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--cycle-steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ~100M params: 12 layers x d_model 512 over the qwen1.5 family
    cfg = dataclasses.replace(
        get_arch("qwen1.5-0.5b"), n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=32_000,
        dtype=torch.float32, remat=False, attn_chunk=128)
    n_params = (cfg.vocab_size * cfg.d_model
                + cfg.n_layers * (4 * cfg.d_model * cfg.d_model
                                  + 3 * cfg.d_model * cfg.d_ff))
    print(f"config: {cfg.n_layers}L d{cfg.d_model} ~{n_params / 1e6:.0f}M "
          f"params on {args.device}")

    shape = ShapeConfig("e2e", args.seq, args.batch, "train",
                        microbatch=args.batch)
    scheme = build_scheme(None, cfg=cfg, shape=shape,
                          steps_per_cycle=args.cycle_steps,
                          optimizer="adamw", device=args.device)
    cycles = max(1, math.ceil(args.steps / args.cycle_steps))
    t0 = time.time()

    def on_cycle(cyc, acc, rep):
        steps = (cyc + 1) * args.cycle_steps
        print(f"cycle {cyc:3d} (step {steps:4d})  loss {rep.loss:.4f}  "
              f"acc {acc:.3f}  ({(time.time() - t0) / steps:.2f}s/step)",
              flush=True)
        assert np.isfinite(rep.loss)

    exp = Experiment(scheme, cycles=cycles, seed=0, n_train=512,
                     n_test=64, lr_schedule=lambda e: 3e-4,
                     on_cycle=on_cycle)
    res = exp.run()

    path = save_checkpoint(args.ckpt_dir, cycles * args.cycle_steps,
                           exp.final_state.train.trainable)
    first, last = res.loss[0], res.loss[-1]
    print(f"loss {first:.3f} -> {last:.3f}; checkpoint {path}")
    assert last < first - 0.5, "expected the LM loss to drop"
    print("end-to-end train OK")
    return res


if __name__ == "__main__":
    main()
