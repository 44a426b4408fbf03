"""A fleet that keeps training while the network fails under it, on the
PyTorch port: bounded ARQ with bursty Gilbert-Elliott outages on every
link, a seeded `FaultPlan`, quorum-gated aggregation, and a mid-run
crash resumed bit for bit from a crash-consistent snapshot. The
counterpart of examples/faulty_fleet.py.

    PYTHONPATH=src python examples/torch_faulty_fleet.py [--cycles 4]
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import WirelessConfig
from repro_torch.schemes import (ClientSpec, Experiment, FaultPlan,
                                 build_scheme)


def make_scheme(seed: int, device):
    # bounded ARQ (3 tx max, then erasure) over a rare bursty outage
    # chain, 10 ms exponential-backoff base billed in time
    base = WirelessConfig(mode="fl", quant_bits=8, snr_db=20.0,
                          arq_max_tx=3, arq_min_f2=0.1,
                          ge_p_gb=0.005, ge_p_bg=0.7,
                          arq_backoff_s=0.01)
    clients = [
        ClientSpec.fl(base, name="phone-a"),
        ClientSpec.fl(base, snr_db=12.0, name="phone-b"),  # weaker link
        ClientSpec.fl(base, snr_db=8.0, name="phone-c"),   # weak link
        ClientSpec.sl(base, name="sensor"),                # split trunk
    ]
    plan = FaultPlan(seed=seed, p_outage=0.15, p_dropout=0.10)
    return build_scheme(base, clients=clients, fault_plan=plan,
                        quorum=0.5, device=device)


def show(cyc, acc, rep):
    met = "committed" if rep.metrics.get("quorum_met", True) \
        else "ABANDONED (below quorum)"
    print(f"cycle {cyc + 1}: test-acc {acc:.4f}  {met}  "
          f"({rep.metrics.get('n_erased', 0)} out, "
          f"{rep.metrics.get('n_dropped_midround', 0)} dropped mid-round, "
          f"backoff {rep.outage_s * 1e3:.1f} ms)")
    for c in rep.clients:
        print(f"    {c.name:8s} {c.status:16s} "
              f"{c.bits / 1e6:7.3f} Mbit ({c.erased_bits / 1e6:.3f} "
              f"erased)  w={c.weight:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("=== faulty fleet, uninterrupted run ===")
    ref = Experiment(make_scheme(args.seed, args.device),
                     cycles=args.cycles, seed=args.seed,
                     n_train=args.n_train, on_cycle=show)
    res = ref.run()
    bits = sum(r.bits for r in ref.reports)
    erased = sum(r.erased_bits for r in ref.reports)
    print(f"fleet total: {bits / 1e6:.3f} Mbit attempted, "
          f"{erased / 1e6:.3f} Mbit erased "
          f"({erased / max(bits, 1): .1%}); "
          f"final accuracy {res.final_accuracy:.4f}")
    assert 0.0 <= erased <= bits

    print("\n=== same run, killed after cycle "
          f"{args.cycles // 2}, resumed ===")
    ckpt = tempfile.mkdtemp(prefix="faulty_fleet_ckpt_")
    try:
        Experiment(make_scheme(args.seed, args.device),
                   cycles=args.cycles // 2, seed=args.seed,
                   n_train=args.n_train, checkpoint_dir=ckpt,
                   checkpoint_every=1).run()
        resumed = Experiment(make_scheme(args.seed, args.device),
                             cycles=args.cycles, seed=args.seed,
                             n_train=args.n_train, on_cycle=show,
                             resume_from=ckpt)
        res2 = resumed.run()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    same = (list(res.accuracy) == list(res2.accuracy)
            and res.total_bits == res2.total_bits
            and [dataclasses.asdict(r) for r in ref.reports]
            == [dataclasses.asdict(r) for r in resumed.reports])
    print(f"\nresumed run bit-for-bit identical "
          f"(trajectory + billing): {same}")
    assert same


if __name__ == "__main__":
    main()
