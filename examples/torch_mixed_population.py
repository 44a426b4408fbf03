"""A heterogeneous client fleet on the PyTorch port — FL, SL and
raw-upload CL devices with their own link budgets, trained by one
server through `Experiment`, with per-round sampling and a deadline
that drops a compute-bound straggler. The counterpart of
examples/mixed_population.py; each round's table is the per-client
breakdown of its `RoundReport`.

    PYTHONPATH=src python examples/torch_mixed_population.py [--cycles 4]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import WirelessConfig
from repro_torch.schemes import (ClientSpec, Experiment, ParticipationPolicy,
                                 build_scheme)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--n-train", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    big = args.n_train // 4
    base = WirelessConfig(mode="fl", quant_bits=8, snr_db=20.0)
    clients = [
        ClientSpec.fl(base, n_samples=big, name="phone-a"),  # 20 dB, Q8
        ClientSpec.fl(base, snr_db=14.0, quant_bits=4,
                      n_samples=big, name="phone-b"),        # lean uplink
        ClientSpec.sl(base, quant_bits=16, name="sensor"),   # offloads trunk
        ClientSpec.cl(base, snr_db=10.0, name="logger"),     # raw upload
        ClientSpec.fl(base, compute_s_per_step=3600.0,
                      name="relic"),                         # never makes it
    ]
    print(f"fleet: {len(clients)} clients — "
          + ", ".join(f"{c.name}({c.paradigm}, {c.wcfg.snr_db:g} dB, "
                      f"Q{c.wcfg.quant_bits})" for c in clients))

    def show(cyc, acc, rep):
        print(f"cycle {cyc + 1}: test-acc {acc:.4f}  "
              f"({rep.metrics['n_active']} active, "
              f"{rep.metrics['n_stragglers']} straggled)")
        for c in rep.clients:
            print(f"    {c.name:8s} {c.paradigm}  {c.status:11s} "
                  f"loss {c.loss:.4f}  {c.bits / 1e6:7.3f} Mbit  "
                  f"{c.energy_j * 1e3:6.3f} mJ  w={c.weight:.2f}")

    exp = Experiment(
        build_scheme(base, clients=clients,
                     policy=ParticipationPolicy.uniform(4),
                     deadline_s=600.0, device=args.device),
        cycles=args.cycles, seed=0, n_train=args.n_train, on_cycle=show)
    res = exp.run()
    print(f"\nlogger's one-time corpus upload: "
          f"{exp.init_delivery.bits / 1e6:.3f} Mbit")
    print(f"fleet total: {res.total_bits / 1e6:.3f} Mbit over "
          f"{args.cycles} cycles; final accuracy {res.final_accuracy:.4f}")
    assert 0.45 < res.final_accuracy < 1.0
    assert all(c.bits == 0.0 for rep in exp.reports
               for c in rep.clients if c.status != "ok")


if __name__ == "__main__":
    main()
