"""The paper's exact 89,673-parameter sentiment model (Section III-A) —
the port of `repro/models/lstm_tiny.py`:

    Embedding(10,001 -> 8)  -> Conv1D(32 filters, k=3, valid) + ReLU
    -> MaxPool1D(2) -> LSTM(32) -> Dense(16, ReLU, L2) -> Dense(1, sigmoid)

The model is layered so the SL split point (after conv+pool, paper Sec.
III-A2) is a first-class boundary: `user_forward` / `server_forward`.

Two routes compute the same function. A forward without autograd on
the card (evaluation, the two-party SL uplink and inference, the SL
privacy capture) runs the hand-written kernels: conv+ReLU+pool through
K3 (`kernels/conv_pool`) and the recurrence through K4
(`kernels/lstm_cell`). Every other forward (training under autograd,
and the CPU) runs the plain ops: the JAX package's three shifted
matmuls and a loop over time in gate order i, f, g, o, not
`nn.Conv1d`/`nn.LSTM` (cuDNN kernels). Parameters are a plain tree
(`nn.core.init_tree`).

Serving streams the classifier as a 2-token-vocabulary decoder
(`cache_shapes` / `init_cache` / `decode_step`): plain ops over an O(1)
cache per slot, neither K3 nor K4, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv_pool.ops import user_conv_pool
from repro_torch.kernels.lstm_cell.ops import lstm_layer
from repro_torch.models.layers import linear, linear_specs
from repro_torch.nn import Spec, resolve_device

EMBED = 8
CONV_F = 32
CONV_K = 3
LSTM_H = 32
DENSE = 16
SEQ = 30


def model_specs(cfg=None, compress_factor: int = 0) -> dict:
    vocab = 10_001 if cfg is None else cfg.vocab_size
    s = {
        "embed": Spec((vocab, EMBED), ("vocab", "embed"), init="embed",
                      scale=0.05),
        "conv_w": Spec((CONV_K, EMBED, CONV_F), ("conv", None, None),
                       init="fan_in"),
        "conv_b": Spec((CONV_F,), (None,), init="zeros"),
        # LSTM weights: input + recurrent for 4 gates (i, f, g, o)
        "lstm_wx": Spec((CONV_F, 4 * LSTM_H), (None, None), init="fan_in"),
        "lstm_wh": Spec((LSTM_H, 4 * LSTM_H), (None, None), init="fan_in"),
        "lstm_b": Spec((4 * LSTM_H,), (None,), init="lstm_forget1"),
        "dense": linear_specs(LSTM_H, DENSE, (None, None), bias=True),
        "out": linear_specs(DENSE, 1, (None, None), bias=True),
    }
    if compress_factor:
        c = CONV_F // compress_factor
        # identity warm start (see core/semantic.py)
        s["sem_enc"] = {"w": Spec((CONV_F, c), (None, None), init="eye"),
                        "b": Spec((c,), (None,), init="zeros")}
        s["sem_dec"] = {"w": Spec((c, CONV_F), (None, None), init="eye"),
                        "b": Spec((CONV_F,), (None,), init="zeros")}
    return s


def _on_kernels(x: torch.Tensor) -> bool:
    """Whether this forward runs K3/K4: on the card, and only without
    autograd, because neither kernel has a backward (the JAX package's
    Pallas kernels have no VJP either). Training keeps the plain ops
    under autograd; the CPU always runs them."""
    return x.is_cuda and not torch.is_grad_enabled()


# ------------------------------------------------- user side (split point)
def user_forward(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding -> Conv1D(valid) + ReLU -> MaxPool(2). The paper's
    user-side partition. Returns smashed data [B, T', CONV_F]."""
    x = params["embed"][tokens.long()]                       # [B,S,8]
    w, b = params["conv_w"], params["conv_b"]
    if _on_kernels(x):
        return user_conv_pool(x, w.contiguous(), b.contiguous())
    S = tokens.shape[1]
    out = x[:, 0:S - CONV_K + 1] @ w[0]
    for i in range(1, CONV_K):
        out = out + x[:, i:S - CONV_K + 1 + i] @ w[i]
    out = torch.relu(out + b)                                 # [B,S-2,32]
    T = out.shape[1] - out.shape[1] % 2
    return out[:, :T].reshape(out.shape[0], T // 2, 2, CONV_F).amax(dim=2)


def lstm_scan(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B,T,F] -> final hidden state [B,H]: the fused-gate cell, one
    step per time index (K4 through `lstm_layer` where `_on_kernels`)."""
    if _on_kernels(x):
        return lstm_layer(x, params["lstm_wx"], params["lstm_wh"],
                          params["lstm_b"])
    B = x.shape[0]
    h = torch.zeros((B, LSTM_H), dtype=x.dtype, device=x.device)
    c = h
    for t in range(x.shape[1]):
        gates = x[:, t] @ params["lstm_wx"] + h @ params["lstm_wh"] \
            + params["lstm_b"]
        i, f, g, o = torch.split(gates, LSTM_H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h


def server_forward(params: dict, smashed: torch.Tensor) -> torch.Tensor:
    """LSTM -> Dense(16, ReLU) -> Dense(1). Returns logits [B, 1]."""
    h = lstm_scan(params, smashed)
    h = torch.relu(linear(params["dense"], h))
    return linear(params["out"], h)


def forward(params: dict, batch: dict, cfg=None, window: int = 0):
    logits = server_forward(params, user_forward(params, batch["tokens"]))
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


# ------------------------------------------------- streaming decode (serving)
# The serving engine treats the classifier as a 2-token-vocab decoder:
# prompt tokens stream in one at a time against an O(1) recurrent cache
# (conv tap buffer + pending pool half + LSTM state), and the "generated
# token" is the sentiment class. Feeding a whole sequence through
# decode_step reproduces forward()'s logits because the conv/pool/LSTM
# pipeline is causal: token i completes conv position i-2, and every
# completed pool PAIR advances the LSTM.

def cache_shapes(cfg, batch_size: int, seq_len: int):
    """(shape, logical axes, dtype) per cache leaf, the transformer
    cache's contract; the batch axis is 0 and `seq_len` is irrelevant
    (the state is O(1) per slot)."""
    B = batch_size
    return {
        "emb": ((B, CONV_K - 1, EMBED), ("batch", None, None), torch.float32),
        "pend": ((B, CONV_F), ("batch", None), torch.float32),
        "h": ((B, LSTM_H), ("batch", None), torch.float32),
        "c": ((B, LSTM_H), ("batch", None), torch.float32),
    }


def init_cache(cfg, batch_size: int, seq_len: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, (shape, axes, dtype) in
            cache_shapes(cfg, batch_size, seq_len).items()}


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                index: torch.Tensor, cfg=None, window: int = 0,
                active=None) -> tuple:
    """token [B,1] int; index a per-slot [B] vector (tokens this row has
    consumed so far). Returns (logits [B,1,2], cache), the cache updated
    in place: softmax over the 2-logit output equals the paper head's
    sigmoid, so argmax/categorical sampling IS the sentiment prediction.
    `active` [B] bool: only those rows' state moves (every row when
    None), the JAX engine's batch select."""
    B = token.shape[0]
    idx = torch.as_tensor(index, device=token.device).reshape(-1)
    idx = idx.expand(B).long()
    e_new = params["embed"][token[:, 0].long()]                   # [B,8]
    e0, e1 = cache["emb"][:, 0], cache["emb"][:, 1]
    w = params["conv_w"]
    conv = torch.relu(e0 @ w[0] + e1 @ w[1] + e_new @ w[2]
                      + params["conv_b"])                         # [B,32]
    j = idx - (CONV_K - 1)          # conv position this token completes
    is_even = ((j >= 0) & (j % 2 == 0))[:, None]
    is_odd = ((j >= 0) & (j % 2 == 1))[:, None]
    pend = torch.where(is_even, conv, cache["pend"])
    pooled = torch.maximum(cache["pend"], conv)   # the pair, when is_odd
    gates = pooled @ params["lstm_wx"] + cache["h"] @ params["lstm_wh"] \
        + params["lstm_b"]
    gi, gf, gg, go = torch.split(gates, LSTM_H, dim=-1)
    c_new = torch.sigmoid(gf) * cache["c"] \
        + torch.sigmoid(gi) * torch.tanh(gg)
    h_new = torch.sigmoid(go) * torch.tanh(c_new)
    h = torch.where(is_odd, h_new, cache["h"])
    c = torch.where(is_odd, c_new, cache["c"])
    z = linear(params["out"],
               torch.relu(linear(params["dense"], h)))            # [B,1]
    logits = torch.cat([torch.zeros_like(z), z], dim=-1)[:, None, :]
    new = {"emb": torch.stack([e1, e_new], dim=1), "pend": pend, "h": h,
           "c": c}
    for k, v in new.items():
        if active is not None:
            keep = active.reshape((B,) + (1,) * (v.ndim - 1))
            v = torch.where(keep, v, cache[k])
        cache[k].copy_(v)
    return logits, cache


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on sigmoid logits."""
    z = logits[:, 0].float()
    y = labels.float()
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return ((logits[:, 0] > 0).to(labels.dtype) == labels).float().mean()
