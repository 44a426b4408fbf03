"""Quickstart on the PyTorch port: train the paper's 89,673-parameter
sentiment model centrally (no radio) through the scheme API, evaluate,
and save a checkpoint — the counterpart of examples/quickstart.py.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data.sentiment import make_splits
from repro_torch.models import lstm_tiny
from repro_torch.schemes import Experiment, build_scheme


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_arch("paper-tinylstm")
    print(f"model: {cfg.name}, {lstm_tiny.n_params():,} params "
          f"(paper: 89,673)")

    scheme = build_scheme(None, device=args.device)   # CL, ideal link
    exp = Experiment(
        scheme, cycles=15, data=make_splits(12_288, seed=0),
        on_cycle=lambda k, acc, rep: print(
            f"epoch {k:2d}  loss {rep.loss:.4f}  test-acc {acc:.4f}"))
    res = exp.run()

    assert res.final_accuracy > 0.70, \
        "expected the sentiment task to be learned"
    path = save_checkpoint(os.path.join(tempfile.gettempdir(),
                                        "repro_torch_quickstart"),
                           exp.final_state.steps,
                           exp.final_state.train.trainable)
    print("checkpoint:", path)


if __name__ == "__main__":
    main()
