"""Federated learning over the wireless channel (paper Alg. 1) on the
PyTorch port — the counterpart of examples/federated_wireless.py.

Three users train locally; every communication cycle their weights are
8-bit quantized, sent through a Rayleigh-fading AWGN channel (one packed
wire launch on the card), FedAvg'd and broadcast back. Reports accuracy,
payload bits and energy.

    PYTHONPATH=src python examples/torch_federated_wireless.py [--snr-db 20]
    PYTHONPATH=src python examples/torch_federated_wireless.py --device cpu \\
        --cycles 1 --n-train 1536 --n-test 256 --min-acc 0
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import WirelessConfig
from repro_torch.core import energy as EN
from repro_torch.schemes import N_TEST, N_TRAIN, Experiment, build_scheme


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr-db", type=float, default=20.0)
    ap.add_argument("--quant-bits", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=N_TRAIN)
    ap.add_argument("--n-test", type=int, default=N_TEST)
    ap.add_argument("--min-acc", type=float, default=0.60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wcfg = WirelessConfig(mode="fl", snr_db=args.snr_db,
                          quant_bits=args.quant_bits)
    print(f"FL: N={wcfg.n_users} users, J={wcfg.local_steps} local epochs, "
          f"Q{wcfg.quant_bits}, SNR {wcfg.snr_db} dB, Rayleigh fading, "
          f"on {args.device}")

    exp = Experiment(
        build_scheme(wcfg, device=args.device), cycles=args.cycles, seed=0,
        n_train=args.n_train, n_test=args.n_test,
        on_cycle=lambda k, acc, rep: print(
            f"cycle {k + 1}: test-acc {acc:.4f}  "
            f"({rep.bits / 1e6:.3f} Mbit, {int(rep.n_tx)} tx)"))
    res = exp.run()

    comm_j = EN.comm_energy_j(res.total_bits, wcfg)
    comp_j = EN.comp_energy_j(res.user_flops)
    print(f"\nper-user payload: {res.total_bits / 1e6:.3f} Mbit "
          f"({res.total_bits / args.cycles / 1e6:.3f} Mbit/cycle; paper "
          f"Table II reports 0.72 Mbit = one Q8 upload of 89,673 params)")
    print(f"comm energy {comm_j:.4f} J | user comp energy {comp_j:.2f} J "
          f"| CO2 {EN.co2_kg(comp_j + comm_j) * 1e6:.2f} mg")
    assert res.final_accuracy > args.min_acc
    return res


if __name__ == "__main__":
    main()
