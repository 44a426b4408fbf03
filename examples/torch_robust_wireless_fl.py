"""Beyond-paper toolbox on the PyTorch port: federated learning on a
harsh link (10 dB, Rayleigh) with link-layer ARQ, coordinate-median
aggregation, and the physical-layer helpers (Hamming(7,4), higher-order
modulation). The counterpart of examples/robust_wireless_fl.py.

    PYTHONPATH=src python examples/torch_robust_wireless_fl.py [--snr-db 10]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import WirelessConfig
from repro_torch.core import channel as CH
from repro_torch.core import coding, modulation
from repro_torch.core.draws import Key
from repro_torch.schemes import Experiment, build_scheme


def _run(wcfg, cycles, device):
    return Experiment(build_scheme(wcfg, device=device), cycles, seed=0,
                      n_train=8192, n_test=1024).run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr-db", type=float, default=10.0)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"--- FL at {args.snr_db} dB over Rayleigh (harsh link) ---")
    fl = dict(mode="fl", quant_bits=8, snr_db=args.snr_db)
    plain = _run(WirelessConfig(**fl), args.cycles, args.device)
    arq = _run(WirelessConfig(arq_attempts=4, **fl), args.cycles,
               args.device)
    median = _run(WirelessConfig(arq_attempts=4, aggregate="median", **fl),
                  args.cycles, args.device)
    print(f"plain FedAvg      : {[round(a, 3) for a in plain.accuracy]} "
          f"({plain.total_bits / 1e6:.2f} Mbit/user)")
    print(f"+ ARQ(4)          : {[round(a, 3) for a in arq.accuracy]} "
          f"({arq.total_bits / 1e6:.2f} Mbit/user)")
    print(f"+ ARQ + median agg: {[round(a, 3) for a in median.accuracy]}")

    # physical-layer helpers at this SNR
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    x = x.to(args.device)
    y_u, _ = CH.transmit_quantized(Key(1).draws(), x, bits=8,
                                   snr_db=args.snr_db, fading=False)
    y_c, _ = coding.transmit_quantized_coded(Key(1).draws(), x, 8,
                                             args.snr_db, fading=False)
    print(f"\npayload MSE uncoded {float(((y_u - x) ** 2).mean()):.5f} "
          f"vs Hamming(7,4) {float(((y_c - x) ** 2).mean()):.5f}")
    for m in modulation.SUPPORTED:
        print(f"  {m:6s}: BER "
              f"{float(modulation.bit_error_prob(m, args.snr_db)):.2e}, "
              f"comm-energy x{modulation.comm_time_scale(m):.3f}")


if __name__ == "__main__":
    main()
