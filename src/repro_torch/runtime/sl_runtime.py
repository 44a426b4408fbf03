"""Split learning as an explicit two-party protocol (paper Alg. 2) — the
port of `repro/runtime/sl_runtime.py`. The fused path
(`core/split.split_forward`) runs a whole SL step as one autograd
graph; THIS module is the deployment shape: user and server are
separate parties exchanging explicit billed messages, so the radio
boundary is a real serialization point.

    session = SLSession(cfg, wcfg, params)                 # model + codec
    for batch in data:
        up = session.user_uplink(batch["tokens"], key)      # USER device
        down = session.server_step(up, batch["labels"], key.fold_in(1))
        session.user_downlink(down)                         # USER device

Each leg goes through the session's `Radio` (one packed-wire send, one
K1 launch on the card) and returns a `Delivery` whose bits the session
accumulates. Keys are `core.draws.Key`s (the draw seam).

The user's uplink forward runs without autograd, so on the card it
launches the conv+pool kernel (K3) once per step; the backward
recomputes that forward under autograd for its gradient, as the JAX
package's `_user_bwd` recomputes it under `jax.vjp`. The server's step
differentiates the plain ops (neither K3 nor K4 has a backward).
`predict` (the SL eval) runs user side, wire and server side without
autograd: K3, K1, then K4 on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import semantic
from repro_torch.models import lstm_tiny
from repro_torch.nn import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import sgd_momentum
from repro_torch.optim.clip import clip_array_by_norm
from repro_torch.schemes.radio import Delivery, Radio

# One radio transmission: received payload + on-air accounting. The
# receiver-side metadata (quantization scale) rides the control channel,
# as in the paper.
Message = Delivery

USER_KEYS = ("embed", "conv_w", "conv_b")


class SLSession:
    """One user + one server for the paper's tiny model. `params` is the
    whole model with its codec, `lstm_tiny.model_specs(cfg,
    wcfg.compress_factor)`'s tree (an `init_tree` of it, or the JAX
    session's weights through `params_from_jax`); the user keeps the
    embedding, the conv and the encoder, the server the rest and the
    decoder."""

    def __init__(self, cfg, wcfg, params: dict, lr: float = 0.1,
                 momentum: float = 0.9):
        self.cfg, self.wcfg = cfg, wcfg
        self.radio = Radio.from_wcfg(wcfg)
        self.user_params = {k: params[k] for k in USER_KEYS}
        self.user_codec = {"enc": params["sem_enc"]}
        self.server_params = {k: v for k, v in params.items()
                              if k not in USER_KEYS
                              and k not in ("sem_enc", "sem_dec")}
        self.server_codec = {"dec": params["sem_dec"]}
        self.lr, self.momentum = lr, momentum
        opt_init, self._opt_update = sgd_momentum(momentum)
        self._user_opt = opt_init({"p": self.user_params,
                                   "c": self.user_codec})
        self._server_opt = opt_init({"p": self.server_params,
                                     "c": self.server_codec})
        self._cached_tokens = None
        self.total_bits = 0
        self.last_loss = None

    # ------------------------------------------------------------- user
    @torch.no_grad()
    def _user_fwd(self, tokens: torch.Tensor) -> torch.Tensor:
        smashed = lstm_tiny.user_forward(self.user_params, tokens)
        return semantic.encode(self.user_codec, smashed)

    def user_uplink(self, tokens: torch.Tensor, key) -> Message:
        """USER: forward through the local partition, compress, transmit."""
        z = self._user_fwd(tokens)
        self._cached_tokens = tokens
        msg = self.radio.send_tree(key.draws(), z)
        self.total_bits += msg.bits
        return msg

    # ----------------------------------------------------------- server
    def server_step(self, up: Message, labels: torch.Tensor, key,
                    lr=None) -> Message:
        """SERVER: decompress, finish the forward, update the server
        weights, transmit the tau-clipped activation gradient back (Alg. 2
        lines 9-14). `lr` None uses the session's construction lr."""
        lr = self.lr if lr is None else lr
        tree = {"p": self.server_params, "c": self.server_codec}
        leaves = [l.detach().requires_grad_() for l in tree_leaves(tree)]
        t = tree_unflatten(tree, leaves)
        z_hat = up.payload.detach().requires_grad_()
        logits = lstm_tiny.server_forward(t["p"],
                                          semantic.decode(t["c"], z_hat))
        loss = lstm_tiny.bce_loss(logits, labels)
        *grads, grad_z = torch.autograd.grad(loss, leaves + [z_hat])
        new, self._server_opt = self._opt_update(
            tree_unflatten(tree, grads), self._server_opt, tree, lr)
        self.server_params, self.server_codec = new["p"], new["c"]
        self.last_loss = loss.detach()
        grad_z = clip_array_by_norm(grad_z, self.wcfg.grad_clip)
        msg = self.radio.send_tree(key.draws(), grad_z)
        self.total_bits += msg.bits
        return msg

    # ------------------------------------------------------ user (bwd)
    def user_downlink(self, down: Message, lr=None) -> None:
        """USER: receive the gradient, backprop the local partition (its
        forward recomputed under autograd) and update; each user-model
        gradient is norm-clipped to tau."""
        lr = self.lr if lr is None else lr
        tree = {"p": self.user_params, "c": self.user_codec}
        leaves = [l.detach().requires_grad_() for l in tree_leaves(tree)]
        t = tree_unflatten(tree, leaves)
        z = semantic.encode(
            t["c"], lstm_tiny.user_forward(t["p"], self._cached_tokens))
        g = tree_unflatten(tree, list(torch.autograd.grad(
            z, leaves, grad_outputs=down.payload)))
        g["p"] = tree_map(lambda x: clip_array_by_norm(
            x, self.wcfg.grad_clip), g["p"])
        new, self._user_opt = self._opt_update(g, self._user_opt, tree, lr)
        self.user_params, self.user_codec = new["p"], new["c"]

    # ----------------------------------------------------------- infer
    @torch.no_grad()
    def predict(self, tokens: torch.Tensor, key,
                perfect: bool = False) -> torch.Tensor:
        """Full inference through the deployed split, radio included
        (the SL eval convention, schemes/split.py); `perfect=True` is
        the `perfect_eval` escape hatch, a noiseless (still quantized)
        link. Not billed as training traffic. Returns logits [B, 1]."""
        radio = (dataclasses.replace(self.radio, perfect=True)
                 if perfect else self.radio)
        up = radio.send_tree(key.draws(), self._user_fwd(tokens))
        smashed_hat = semantic.decode(self.server_codec, up.payload)
        return lstm_tiny.server_forward(self.server_params, smashed_hat)
