"""Energy and CO2 accounting (paper Sec. II-D, Eq. 11, Table II) — the
port of `repro/core/energy.py`. numpy only, so the numbers are the JAX
package's bit for bit.

Communication: Shannon-Hartley, C = B log2(1 + |f|^2 SNR); the expected
capacity under Rayleigh fading, E_f[C], is a Monte-Carlo mean over
|f|^2 ~ Exp(1); comm energy = payload bits x P / E[C]. Computation: the
paper measured its user device's energy; the JAX package models it as
FLOPs x 1 nJ/FLOP (an MCU / edge-CPU class device), and so does the
port. CO2: energy (kWh) x 0.475 kg CO2/kWh, the Eco2AI grid intensity.
"""
from __future__ import annotations

import dataclasses

import numpy as np

J_PER_FLOP_EDGE = 1e-9
CO2_KG_PER_KWH = 0.475


def snr_linear(snr_db: float) -> float:
    return 10.0 ** (snr_db / 10.0)


def channel_capacity(bandwidth_hz: float, snr_db: float, fading: bool = True,
                     n_mc: int = 10_000, seed: int = 0) -> float:
    """E[C] in bits/s (Eq. 11), Monte-Carlo over Rayleigh |f|^2 ~ Exp(1)."""
    snr = snr_linear(snr_db)
    if not fading:
        return bandwidth_hz * np.log2(1.0 + snr)
    rng = np.random.default_rng(seed)
    f2 = rng.exponential(1.0, n_mc)
    return float(bandwidth_hz * np.mean(np.log2(1.0 + f2 * snr)))


def comm_energy_j(payload_bits: float, wcfg) -> float:
    """payload_bits * P / E[C]  (J)."""
    cap = channel_capacity(wcfg.bandwidth_hz, wcfg.snr_db, wcfg.fading)
    return float(payload_bits) * wcfg.tx_power_w / cap


def comm_time_s(payload_bits: float, wcfg) -> float:
    """payload_bits / E[C]  (s on air)."""
    cap = channel_capacity(wcfg.bandwidth_hz, wcfg.snr_db, wcfg.fading)
    return float(payload_bits) / cap


def comp_energy_j(flops: float) -> float:
    """Computation energy of `flops` on the paper's user device (the
    JAX package's "edge" class)."""
    return float(flops) * J_PER_FLOP_EDGE


def co2_kg(energy_j: float) -> float:
    return energy_j / 3.6e6 * CO2_KG_PER_KWH


@dataclasses.dataclass
class EnergyReport:
    """A run's totals: payload bits and the FLOPs on each side; the
    summary charges the user side's FLOPs at the edge device's energy
    per FLOP (the JAX package's default device)."""
    total_bits: float = 0.0
    comp_flops_user: float = 0.0
    comp_flops_server: float = 0.0

    def summary(self, wcfg) -> dict:
        comp = comp_energy_j(self.comp_flops_user)
        comm = comm_energy_j(self.total_bits, wcfg)
        return {
            "total_bits": self.total_bits,
            "comp_energy_j": comp,
            "comm_energy_j": comm,
            "total_energy_j": comp + comm,
            "co2_kg": co2_kg(comp + comm),
        }
