"""CentralizedScheme: the paper's CL baseline behind the Scheme API —
the port of `repro/schemes/centralized.py`. The raw dataset crosses the
channel ONCE at `init` (bit errors corrupt token ids directly — paper
Fig. 3d); the server then trains normally, one epoch per round. The
token uplink has no kernel of its own (`Radio.send_tokens`). With
`capture=True` the scheme keeps the received corpus and the original
(the privacy study's direct read)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.draws import Key
from repro_torch.nn import resolve_device
from repro_torch.runtime.train_step import init_train_state, make_train_step
from repro_torch.schemes.base import (BATCH, CFG, MOMENTUM, RoundReport,
                                      SchemeState, batches_of, evaluate,
                                      step_flops, train_cycle, train_shape)
from repro_torch.schemes.radio import Radio

UPLOAD_STREAM = 7    # the corpus upload draws on key(seed + 7)


def cl_train_step(lr: float):
    """The no-radio train step at learning rate `lr`."""
    return make_train_step(CFG, train_shape(), None, optimizer="sgd", lr=lr,
                           momentum=MOMENTUM)


class CentralizedScheme:
    mode = "cl"
    epochs_per_cycle = 1
    bits_normalizer = 1.0

    def __init__(self, wcfg=None, capture: bool = False, device="cuda",
                 key=Key):
        self.wcfg = wcfg
        self.device = resolve_device(device)
        self.key = key
        self.radio = Radio.from_wcfg(wcfg)
        self.capture = capture
        self.captures: dict = {}

    # ------------------------------------------------------------- setup
    def init(self, seed: int, xtr, ytr):
        clean = torch.from_numpy(np.asarray(xtr)).to(self.device)
        dlv = self.radio.send_tokens(
            self.key(seed + UPLOAD_STREAM).draws(), clean, CFG.vocab_size,
            labels=torch.from_numpy(np.asarray(ytr)))
        xtr_rx = dlv.payload.cpu().numpy()
        if self.capture:
            self.captures = {"received": xtr_rx.copy(),
                             "original": np.asarray(xtr).copy()}
        g = torch.Generator().manual_seed(seed)
        state = init_train_state(g, CFG, None, "sgd", MOMENTUM, self.device)
        return SchemeState(train=state, data=(xtr_rx, np.asarray(ytr))), dlv

    def cycle_batches(self, state, rng, cycle):
        xtr, ytr = state.data
        return batches_of(xtr, ytr, BATCH, rng, self.device)

    def round_key(self, seed: int, cycle: int):
        return self.key(seed + 2)

    # ------------------------------------------------------------- round
    def round(self, state, batch, key, lr):
        st, m, steps = train_cycle(cl_train_step(lr), state.train, batch,
                                   key, state.steps)
        new = SchemeState(st, state.data, steps, state.epoch + 1)
        # the data upload was charged at init; rounds are radio-silent
        return new, RoundReport(loss=float(m["loss"]),
                                steps=steps - state.steps)

    # -------------------------------------------------------------- eval
    def evaluate(self, state, xte, yte) -> float:
        return evaluate(state.train.trainable["model"], xte, yte)[0]

    def flops(self, steps_total: int):
        return 0.0, step_flops("cl") * steps_total   # paper: CL user = 0
