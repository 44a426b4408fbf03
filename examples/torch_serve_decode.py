"""Serve a reduced qwen1.5-0.5b with batched decode requests on the
PyTorch port (the attention kernels K7-K10 on the card) — the
counterpart of examples/serve_decode.py.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = serve.main(["--arch", args.arch, "--reduced", "--batch", "4",
                      "--prompt-len", "16", "--new-tokens", "16",
                      "--device", args.device])
    assert res["generated"].shape == (4, 16)
    print("serve OK")


if __name__ == "__main__":
    main()
