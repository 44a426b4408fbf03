"""Split learning as an explicit two-party wireless protocol (Alg. 2) on
the PyTorch port — the counterpart of examples/split_wireless.py: the
user computes embedding -> conv -> pool (K3 on the card), compresses x4,
sends through the channel; the server finishes, backprops, and sends the
tau-clipped gradient back. Every leg is a billed `Delivery`.

    PYTHONPATH=src python examples/torch_split_wireless.py [--snr-db 20]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import WirelessConfig
from repro_torch.core import energy as EN
from repro_torch.data.sentiment import make_splits
from repro_torch.schemes import Experiment, build_scheme


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr-db", type=float, default=20.0)
    ap.add_argument("--quant-bits", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wcfg = WirelessConfig(mode="sl", snr_db=args.snr_db,
                          quant_bits=args.quant_bits)
    print(f"SL: split after conv+pool, x{wcfg.compress_factor} semantic "
          f"compression, Q{wcfg.quant_bits} transport, tau={wcfg.grad_clip}")

    scheme = build_scheme(wcfg, protocol="two_party", device=args.device)
    total = [0.0]

    def report(k, acc, rep):
        total[0] += rep.bits
        print(f"epoch {k:2d}  loss {rep.loss:.4f}  test-acc {acc:.4f}  "
              f"radio {total[0] / 1e6:.1f} Mbit")

    res = Experiment(scheme, cycles=args.epochs,
                     data=make_splits(12_288, seed=0),
                     on_cycle=report).run()

    comm_j = EN.comm_energy_j(res.total_bits, wcfg)
    print(f"\ncomm energy {comm_j:.3f} J (paper: SL pays the radio, "
          f"saves user compute)")


if __name__ == "__main__":
    main()
