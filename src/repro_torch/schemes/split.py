"""SplitScheme: the paper's SL (Alg. 2) behind the Scheme API, fused
protocol — the port of `repro/schemes/split.py`. The two-party protocol
(`SLSession`) is still to port (ROADMAP.md) and raises.

One fused step sends the compressed activation up and the tau-clipped
gradient down through the packed wire (`core/channel.channel_crossing`:
one kernel launch per leg on the card). Its bill is replayed outside
the step from the same keys (`sl_cycle_drawn_diag`): the fade/ARQ draw
of each leg is the "arq" draw of the leg's key, so the replay bills
exactly what the step drew.

Eval: the deployed function transmits through the REAL channel with
fixed eval keys (`evaluate_sl`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig
from repro_torch.core import wire as W
from repro_torch.core.draws import Key
from repro_torch.core.split import split_forward
from repro_torch.models import lstm_tiny
from repro_torch.nn import resolve_device
from repro_torch.runtime.train_step import init_train_state, make_train_step
from repro_torch.schemes.base import (BATCH, CFG, LR0, MOMENTUM, RoundReport,
                                      SchemeState, batches_of, step_flops,
                                      train_cycle, train_shape,
                                      user_side_flops_sl)
from repro_torch.schemes.radio import Radio

EVAL_KEY = 999     # slice i of the test set is scored on Key(999 + i)


def sl_train_step(wcfg, lr: float):
    """The fused SL train step at learning rate `lr`."""
    step = make_train_step(CFG, train_shape(), wcfg, optimizer="sgd",
                           lr=LR0, momentum=MOMENTUM)
    return lambda st, b, k: step(st, b, k, lr)


def sl_bits_per_step(wcfg, quant_bits: int) -> float:
    """On-air payload of ONE fused SL step: compressed activation up +
    tau-clipped gradient down (2 legs x B x T_pool x C/compress)."""
    t_pool = (lstm_tiny.SEQ - lstm_tiny.CONV_K + 1) // 2
    c = lstm_tiny.CONV_F // wcfg.compress_factor
    return 2.0 * BATCH * t_pool * c * float(quant_bits)


sl_cycle = train_cycle


def sl_cycle_drawn_diag(key, start: int, n_steps: int, radio: Radio):
    """(n_tx, n_erased_legs, backoff_units) totals over both legs of
    `n_steps` fused SL steps from cumulative step `start` under the
    cycle's `key`: each step's link key is key.fold_in(step).fold_in(0)
    (microbatch 0), its gradient leg that .fold_in(1); the "arq" draw of
    each is replayed. (2 * n_steps, 0, 0) on a fault-free link."""
    if n_steps <= 0:
        return 0.0, 0.0, 0.0
    if W.fault_free(radio.fading, radio.perfect, radio.arq_attempts,
                    radio.arq_min_f2, radio.arq_max_tx, radio.ge_p_gb):
        return 2.0 * n_steps, 0.0, 0.0
    kw = dict(fading=radio.fading, perfect=False,
              arq_attempts=radio.arq_attempts, arq_min_f2=radio.arq_min_f2,
              arq_max_tx=radio.arq_max_tx, ge_p_gb=radio.ge_p_gb,
              ge_p_bg=radio.ge_p_bg)
    tx = er = 0
    bo = np.float32(0.0)
    for s in range(start, start + n_steps):
        ck = key.fold_in(s).fold_in(0)
        for leg in (ck, ck.fold_in(1)):
            t, e, b = W.drawn_tree_diag(leg.draws(), 1, **kw)
            tx, er, bo = tx + t, er + e, bo + np.float32(b)
    return float(tx), float(er), float(bo)


def sl_cycle_drawn_tx(key, start: int, n_steps: int, radio: Radio) -> float:
    """DRAWN transmissions of `n_steps` fused SL steps."""
    return sl_cycle_drawn_diag(key, start, n_steps, radio)[0]


@torch.no_grad()
def evaluate_sl(trainable, wcfg, xte, yte, batch: int = 2048,
                key=Key) -> float:
    """Test accuracy of the deployed split function: user partition +
    codec + link + server partition, through the REAL channel with the
    fixed per-slice keys key(999 + slice_start)."""
    dev = trainable["model"]["embed"].device
    accs = []
    for i in range(0, max(len(xte) - batch + 1, 1), batch):
        tokens = torch.from_numpy(np.ascontiguousarray(
            xte[i:i + batch])).to(dev)
        labels = torch.from_numpy(np.ascontiguousarray(
            yte[i:i + batch])).to(dev)
        logits, _ = split_forward(trainable["model"], trainable["codec"],
                                  {"tokens": tokens}, CFG, wcfg,
                                  key(EVAL_KEY + i))
        accs.append(float(lstm_tiny.accuracy(logits, labels)))
    return float(np.mean(accs))


class SplitScheme:
    mode = "sl"
    epochs_per_cycle = 1
    bits_normalizer = 1.0

    def __init__(self, wcfg=None, capture: bool = False,
                 protocol: str = "fused", device="cuda", key=Key):
        if protocol == "two_party":
            raise NotImplementedError(
                "SplitScheme: the two-party protocol (SLSession, "
                "runtime/sl_runtime.py) is not ported yet (see ROADMAP.md)")
        if protocol != "fused":
            raise ValueError(protocol)
        if capture:
            raise NotImplementedError(
                "SplitScheme: privacy capture is not ported yet "
                "(see ROADMAP.md)")
        self.wcfg = wcfg or WirelessConfig(mode="sl", quant_bits=16)
        self.device = resolve_device(device)
        self.key = key
        self.radio = Radio.from_wcfg(self.wcfg)
        self.protocol = protocol
        self.captures: dict = {}
        self.bits_per_batch = sl_bits_per_step(self.wcfg,
                                               self.radio.quant_bits)

    # ------------------------------------------------------------- setup
    def init(self, seed: int, xtr, ytr):
        g = torch.Generator().manual_seed(seed)
        state = init_train_state(g, CFG, self.wcfg, "sgd", MOMENTUM,
                                 self.device)
        return SchemeState(train=state, data=(np.asarray(xtr),
                                              np.asarray(ytr))), None

    def cycle_batches(self, state, rng, cycle):
        xtr, ytr = state.data
        return batches_of(xtr, ytr, BATCH, rng, self.device)

    def round_key(self, seed: int, cycle: int):
        return self.key(seed + 2)

    # ------------------------------------------------------------- round
    def round(self, state, batch, key, lr):
        st, m, steps = sl_cycle(sl_train_step(self.wcfg, lr), state.train,
                                batch, key, state.steps)
        n = steps - state.steps
        new = SchemeState(st, state.data, steps, state.epoch + 1)
        n_tx, n_er, bo = sl_cycle_drawn_diag(key, state.steps, n,
                                             self.radio)
        leg_bits = self.bits_per_batch / 2.0
        bits = n_tx * leg_bits
        return new, RoundReport(
            loss=float(m["loss"]), steps=n, bits=bits, n_tx=n_tx,
            energy_j=self.radio.energy_j(bits),
            erased_bits=n_er * self.radio.arq_max_tx * leg_bits,
            outage_s=bo * self.radio.arq_backoff_s)

    # -------------------------------------------------------------- eval
    def evaluate(self, state, xte, yte) -> float:
        return evaluate_sl(state.train.trainable, self.wcfg, xte, yte,
                           key=self.key)

    def flops(self, steps_total: int):
        cf = self.wcfg.compress_factor
        user = user_side_flops_sl(cf) * steps_total
        server = (step_flops("sl", cf) - user_side_flops_sl(cf)) \
            * steps_total
        return user, server
