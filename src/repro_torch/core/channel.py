"""Wireless channel: Rayleigh fading + AWGN over BPSK (paper Eq. 10) —
the port of `repro/core/channel.py`.

With BPSK, coherent detection and a known fade f, each bit flips
independently with p = Q(sqrt(2 |f|^2 SNR)), so the modulate / fade /
demodulate chain is XOR-ing the codewords with Bernoulli(p) bit noise.
Plane b of a codeword flips iff fmix32(word ^ (b+1)*GOLDEN) < p * 2^32,
from ONE 32-bit random word per element (core/wire.py). Random numbers
come through the `Draws` seam (core/draws.py).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import quantization as Q
from repro_torch.core import wire as W
from repro_torch.optim.clip import clip_array_by_norm


def snr_linear(snr_db) -> torch.Tensor:
    return 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)


def rayleigh_gain(draws, name: str = "fade") -> torch.Tensor:
    """|f|^2 with E[|f|^2] = 1 (one draw per transmission)."""
    return -torch.log(draws.uniform(name, (), 1e-12, 1.0))


def rayleigh_gain_arq(draws, attempts: int, min_f2: float,
                      name: str = "fade"):
    """Outage-aware ARQ: redraw the fade up to `attempts` times until
    |f|^2 >= min_f2. Returns (|f|^2 used, transmissions used)."""
    f2s = -torch.log(draws.uniform(name, (attempts,), 1e-12, 1.0))
    ok = f2s >= min_f2
    first = int(ok.to(torch.int64).argmax())
    any_ok = bool(ok.any())
    idx = first if any_ok else attempts - 1
    return f2s[idx], (first + 1 if any_ok else attempts)


def bpsk_bit_error_prob(snr_db, f2) -> torch.Tensor:
    """p = Q(sqrt(2 |f|^2 SNR)) for coherent BPSK, as float32.

    The argument x = sqrt(2 |f|^2 SNR) / sqrt(2) is formed in float32
    as the JAX package forms it, each step correctly rounded (torch's
    float32 sqrt on the CPU is not: it is off by an ulp for some
    inputs, and erfc's slope turns one ulp of x into ~2e-6 of p); then
    0.5 erfc(x) is evaluated in float64 and rounded once to float32
    (torch's float32 erfc is up to ~3e-6 relative off the exact value).
    The result lies within 5e-7 of JAX's."""
    f2 = torch.as_tensor(f2, dtype=torch.float32)
    prod = 2.0 * f2 * snr_linear(snr_db)
    arg = torch.sqrt(prod.double()).float()
    x = arg / torch.tensor(math.sqrt(2.0), dtype=torch.float32)
    return (0.5 * torch.special.erfc(x.double())).float()


def flip_bits(draws, codewords: torch.Tensor, n_bits: int, p) -> torch.Tensor:
    """XOR codewords (int64 holding values < 2^n_bits) with iid
    Bernoulli(p) bits; one "flip" word per element. `p` broadcasts
    against `codewords` (per-row fading)."""
    rand = draws.words("flip", codewords.shape).to(codewords.device)
    return codewords ^ W.bit_flip_mask(rand, n_bits, p)


def transmit_tokens(draws, tokens: torch.Tensor, vocab_size: int,
                    snr_db: float, fading: bool = True) -> torch.Tensor:
    """CL / serving uplink: raw token ids cross the channel as fixed-width
    codewords, one Rayleigh fade per ROW (one packet per row)."""
    n_bits = max(1, (int(vocab_size) - 1).bit_length())
    if fading:
        n_rows = tokens.shape[0] if tokens.ndim > 1 else 1
        u = draws.uniform("fade", (n_rows,), 1e-12, 1.0)
        f2 = -torch.log(u)
        if tokens.ndim > 1:
            f2 = f2.reshape((n_rows,) + (1,) * (tokens.ndim - 1))
    else:
        f2 = torch.tensor(1.0, dtype=torch.float32)
    p = bpsk_bit_error_prob(snr_db, f2).to(tokens.device)
    code = flip_bits(draws, tokens.long() & W.M32, n_bits, p)
    return torch.clamp(code, max=vocab_size - 1).to(tokens.dtype)


def transmit_quantized(draws, x: torch.Tensor, bits: int, snr_db: float,
                       fading: bool = True, perfect: bool = False,
                       arq_attempts: int = 1, arq_min_f2: float = 0.25):
    """Full chain on one tensor with its own per-tensor scale. Returns
    (x_hat, diag {"f2", "ber", "n_tx"})."""
    q, s = Q.quantize(x, bits)
    if perfect:
        return Q.dequantize(q, s, x.dtype), {"f2": 1.0, "ber": 0.0,
                                             "n_tx": 1}
    if not fading:
        f2, n_tx = torch.tensor(1.0), 1
    elif arq_attempts > 1:
        f2, n_tx = rayleigh_gain_arq(draws, arq_attempts, arq_min_f2)
    else:
        f2, n_tx = rayleigh_gain(draws), 1
    p = draws.bit_error_prob(snr_db, f2).to(x.device)
    code = flip_bits(draws, Q.quantize_offset(q, bits), bits, p)
    q_hat = Q.unquantize_offset(code, bits)
    return Q.dequantize(q_hat, s, x.dtype), {"f2": f2, "ber": p,
                                             "n_tx": n_tx}


# --------------------------------------------------------------- SL link
def _link_kw(link: dict) -> dict:
    return {k: link[k] for k in ("bits", "snr_db", "fading", "perfect",
                                 "arq_attempts", "arq_min_f2",
                                 "arq_max_tx", "ge_p_gb", "ge_p_bg")}


class _ChannelCrossing(torch.autograd.Function):
    """Forward: the activation through the packed wire on `key`'s
    stream. Backward: the gradient norm-clipped to tau, sent on its own
    stream (`key.fold_in(1)`, the JAX package's fold) and clipped again
    on arrival."""

    @staticmethod
    def forward(ctx, x, key, link):
        ctx.key, ctx.link = key, link
        if x.is_meta:       # a shape-only pass (FLOP counting) sends nothing
            return x.clone()
        return W.transmit_tree(key.draws(), x, **_link_kw(link))

    @staticmethod
    def backward(ctx, g):
        if g.is_meta:
            return g.clone(), None, None
        tau = ctx.link["grad_clip"]
        g = clip_array_by_norm(g, tau)
        g_hat = W.transmit_tree(ctx.key.fold_in(1).draws(), g,
                                **_link_kw(ctx.link))
        # receiver-side re-clip: a deep fade flips high-order bits and
        # can blow the received norm up; the receiver knows tau
        return clip_array_by_norm(g_hat, tau), None, None


def channel_crossing(x, key, bits, snr_db, fading, grad_clip, perfect,
                     arq_attempts=1, arq_min_f2=0.25, arq_max_tx=0,
                     ge_p_gb=0.0, ge_p_bg=0.5) -> torch.Tensor:
    """The SL radio boundary (Alg. 2): the forward activation AND the
    backward gradient both traverse quantize -> BPSK -> Rayleigh+AWGN
    through the packed wire (one kernel launch per leg on the card).
    The gradient is norm-clipped to `grad_clip` (tau) before sending.
    `key` is a `core.draws.Key` (or anything with `draws()` and
    `fold_in`). An ERASED leg arrives as zeros."""
    link = dict(bits=int(bits), snr_db=snr_db, fading=bool(fading),
                perfect=bool(perfect), arq_attempts=int(arq_attempts),
                arq_min_f2=float(arq_min_f2), arq_max_tx=int(arq_max_tx),
                ge_p_gb=float(ge_p_gb), ge_p_bg=float(ge_p_bg),
                grad_clip=float(grad_clip))
    return _ChannelCrossing.apply(x, key, link)


def transmit_pytree(draws, tree, bits, snr_db, fading=True, perfect=False):
    """Quantize+channel every leaf (FL weight upload, Alg. 1) in one
    packed-wire pass. Returns (tree_hat, payload bits as float)."""
    out = W.transmit_tree(draws, tree, bits=bits, snr_db=snr_db,
                          fading=fading, perfect=perfect)
    return out, W.payload_bits(tree, bits)
