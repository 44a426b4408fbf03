"""SplitScheme: the paper's SL (Alg. 2) behind the Scheme API — the port
of `repro/schemes/split.py`. Two protocols, one interface:

* ``protocol="fused"`` (default): one fused step sends the compressed
  activation up and the tau-clipped gradient down through the packed
  wire (`core/channel.channel_crossing`: one K1 launch per leg on the
  card). Its bill is replayed outside the step from the same keys
  (`sl_cycle_drawn_diag`): the fade/ARQ draw of each leg is the "arq"
  draw of the leg's key, so the replay bills exactly what the step drew.
* ``protocol="two_party"``: user and server are separate parties
  exchanging explicit `Delivery` messages (`runtime/sl_runtime.py`
  `SLSession`), billed as they are sent, on the same lr schedule.

Eval (both protocols): the deployed function transmits through the REAL
channel with fixed eval keys (`evaluate_sl`, `SLSession.predict`); on the
card it runs the no-grad kernels K3 and K4 once per eval slice.
`perfect_eval=True` scores over a noiseless (still quantized) link
instead, to separate model quality from channel luck.

Privacy capture (`capture=True`) records what the server receives on the
uplink every `capture_every` steps, with the raw tokens it came from:
the fused protocol runs the user side again and sends it over its own
key (`sl_observe`), the two-party protocol keeps the uplink's payload.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig
from repro_torch.core import semantic
from repro_torch.core import wire as W
from repro_torch.core.draws import Key
from repro_torch.core.split import split_forward
from repro_torch.models import lstm_tiny
from repro_torch.nn import init_tree, resolve_device
from repro_torch.runtime import sl_runtime
from repro_torch.runtime.train_step import init_train_state, make_train_step
from repro_torch.schemes.base import (BATCH, CFG, LR0, MOMENTUM, RoundReport,
                                      SchemeState, batches_of, step_flops,
                                      train_cycle, train_shape,
                                      user_side_flops_sl)
from repro_torch.schemes.radio import Radio

EVAL_KEY = 999     # slice i of the test set is scored on Key(999 + i)
CAPTURE_FOLD = 12345   # a fused capture sends on its step key's fold


def _wcfg_key(wcfg) -> tuple:
    """A WirelessConfig as a sorted, hashable tuple of its fields (the
    fleet engine's config table is keyed on it)."""
    return tuple(sorted(dataclasses.asdict(wcfg).items()))


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
                key=Key, perfect_eval: bool = False) -> float:
    """Test accuracy of the deployed split function: user partition +
    codec + link + server partition, through the REAL channel with the
    fixed per-slice keys key(999 + slice_start); `perfect_eval` scores
    over a noiseless (still quantized) link."""
    if perfect_eval:
        wcfg = dataclasses.replace(wcfg, perfect_channel=True)
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


@torch.no_grad()
def evaluate_two_party(sess, xte, yte, batch: int = 2048,
                       key=Key, perfect: bool = False) -> float:
    """`evaluate_sl` for the two-party protocol: each slice through
    `SLSession.predict` on key(999 + slice_start)."""
    dev = sess.user_params["embed"].device
    accs = []
    for i in range(0, max(len(xte) - batch + 1, 1), batch):
        tokens = torch.from_numpy(np.ascontiguousarray(
            xte[i:i + batch])).to(dev)
        labels = torch.from_numpy(np.ascontiguousarray(
            yte[i:i + batch])).to(dev)
        logits = sess.predict(tokens, key(EVAL_KEY + i), perfect=perfect)
        accs.append(float(lstm_tiny.accuracy(logits, labels)))
    return float(np.mean(accs))


@torch.no_grad()
def sl_observe(trainable, tokens, key, wcfg):
    """What the SERVER receives on the SL uplink: the user partition
    (K3 on the card), the encoder, then the same packed-wire crossing
    the fused step uses, on `key`'s stream."""
    smashed = lstm_tiny.user_forward(trainable["model"], tokens)
    z = semantic.encode(trainable["codec"], smashed)
    return W.transmit_tree(key.draws(), z, bits=wcfg.quant_bits,
                           snr_db=wcfg.snr_db, fading=wcfg.fading,
                           perfect=wcfg.perfect_channel)


class SplitScheme:
    mode = "sl"
    epochs_per_cycle = 1
    bits_normalizer = 1.0

    def __init__(self, wcfg=None, capture: bool = False,
                 capture_every: int = 8, protocol: str = "fused",
                 perfect_eval: bool = False, device="cuda", key=Key):
        if protocol not in ("fused", "two_party"):
            raise ValueError(protocol)
        self.wcfg = wcfg or WirelessConfig(mode="sl", quant_bits=16)
        self.device = resolve_device(device)
        self.key = key
        self.radio = Radio.from_wcfg(self.wcfg)
        self.protocol = protocol
        # eval convention: the deployed function transmits through the
        # REAL channel (see evaluate_sl); perfect_eval scores noiseless
        self.perfect_eval = perfect_eval
        self.capture = capture
        self.capture_every = capture_every
        self.captures = {"smashed": [], "original": []} if capture else {}
        self.bits_per_batch = sl_bits_per_step(self.wcfg,
                                               self.radio.quant_bits)

    # ------------------------------------------------------------- setup
    def init(self, seed: int, xtr, ytr):
        g = torch.Generator().manual_seed(seed)
        if self.protocol == "two_party":
            params = init_tree(lstm_tiny.model_specs(
                CFG, self.wcfg.compress_factor), g, self.device)
            train = sl_runtime.SLSession(CFG, self.wcfg, params,
                                         lr=LR0, momentum=MOMENTUM)
        else:
            train = init_train_state(g, CFG, self.wcfg, "sgd", MOMENTUM,
                                     self.device)
        return SchemeState(train=train, data=(np.asarray(xtr),
                                              np.asarray(ytr))), None

    def cycle_batches(self, state, rng, cycle):
        xtr, ytr = state.data
        return batches_of(xtr, ytr, BATCH, rng, self.device)

    def round_key(self, seed: int, cycle: int):
        return self.key(seed + 2)

    # ------------------------------------------------------------- round
    def _keep(self, z, tokens) -> None:
        self.captures["smashed"].append(z.cpu().numpy())
        self.captures["original"].append(tokens.cpu().numpy())

    def _capture_step(self, steps, st, b, kb):
        if steps % self.capture_every == 0:
            self._keep(sl_observe(st.trainable, b["tokens"],
                                  kb.fold_in(CAPTURE_FOLD), self.wcfg),
                       b["tokens"])

    def round(self, state, batch, key, lr):
        if self.protocol == "two_party":
            return self._round_two_party(state, batch, key, lr)
        st, m, steps = sl_cycle(
            sl_train_step(self.wcfg, lr), state.train, batch, key,
            state.steps, on_step=self._capture_step if self.capture
            else None)
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

    def _round_two_party(self, state, batch, key, lr):
        sess, steps = state.train, state.steps
        bits0, n_tx = sess.total_bits, 0.0
        for b in batch:
            kb = key.fold_in(steps)
            up = sess.user_uplink(b["tokens"], kb)
            down = sess.server_step(up, b["labels"], kb.fold_in(1), lr=lr)
            sess.user_downlink(down, lr=lr)
            n_tx += up.n_tx + down.n_tx
            if self.capture and steps % self.capture_every == 0:
                self._keep(up.payload, b["tokens"])
            steps += 1
        bits = sess.total_bits - bits0
        new = SchemeState(sess, state.data, steps, state.epoch + 1)
        return new, RoundReport(
            loss=float(sess.last_loss), steps=steps - state.steps,
            bits=bits, n_tx=n_tx, energy_j=self.radio.energy_j(bits))

    # -------------------------------------------------------------- eval
    def evaluate(self, state, xte, yte) -> float:
        if self.protocol == "two_party":
            return evaluate_two_party(state.train, xte, yte, key=self.key,
                                      perfect=self.perfect_eval)
        return evaluate_sl(state.train.trainable, self.wcfg, xte, yte,
                           key=self.key, perfect_eval=self.perfect_eval)

    def flops(self, steps_total: int):
        cf = self.wcfg.compress_factor
        user = user_side_flops_sl(cf) * steps_total
        server = (step_flops("sl", cf) - user_side_flops_sl(cf)) \
            * steps_total
        return user, server
