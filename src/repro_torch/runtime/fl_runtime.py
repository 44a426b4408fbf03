"""Federated-learning runtime for the paper's tiny model — the tiny part
of `repro/runtime/fl_runtime.py`: N users, J local epochs each (a loop
over users), quantized weight upload through the channel, FedAvg,
broadcast. The pod-mesh FL step of the scaled families is still to port
(ROADMAP.md)."""
from __future__ import annotations

from repro_torch.core import federated as FED
from repro_torch.runtime.train_step import TrainState, make_local_step

SYNC_KEY_FOLD = 999   # the sync's channel key is round key .fold_in(999)


def make_local_step_tiny(cfg, wcfg, lr, momentum: float = 0.9,
                         prox_mu: float = 0.0, anchor=None):
    """Local SGD step for the paper's tiny model — the shared
    `make_local_step` core (FL local steps are radio-free; `wcfg` is
    kept for call-site compatibility); with prox_mu > 0 it is FedProx,
    pulled toward `anchor` ({"model": broadcast, "codec": {}})."""
    del wcfg
    return make_local_step(cfg, lr, momentum, prox_mu, anchor)


def fl_round_tiny(key, user_states, user_batches, cfg, wcfg, lr):
    """One communication cycle k. user_batches leaves [N, J, ...]; `key`
    is a `core.draws.Key`. Returns (state, metrics [N, J], bits)."""
    local_step = make_local_step_tiny(cfg, wcfg, lr)
    states, metrics = FED.local_steps_vmapped(local_step, user_states,
                                              user_batches)
    avg, bits = FED.fedavg_through_channel(
        key.fold_in(SYNC_KEY_FOLD).draws(), states.trainable["model"], wcfg)
    new_trainable = dict(states.trainable, model=avg)
    return TrainState(new_trainable, states.opt_state, states.step), \
        metrics, bits
