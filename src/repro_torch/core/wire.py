"""Packed-pytree fused wire: one-shot quantize -> bit-flip channel ->
dequantize for whole weight/activation trees (the FL/SL hot path) — the
port of `repro/core/wire.py`.

Every FL communication cycle pushes the full weight tree of every user
through the radio chain (Alg. 1 lines 8-11) and every SL step pushes
the smashed activation and its gradient through it (Alg. 2 line 6).
The packed wire does a whole tree in ONE pass.

Layout (`WirePlan`): each leaf (in sorted-key order, JAX's dict-pytree
order) is flattened row-major to float32 and padded to whole
`WIRE_COLS`-wide rows; leaf rows are concatenated into one [R, cols]
buffer, R padded to a multiple of 8. A packet is a leaf, or a
(user, leaf) pair for stacked sends; its quantization scale and bit
error probability are per-ROW [R, 1] vectors beside the buffer.

Random numbers come from the caller's `Draws` (core/draws.py): "arq"
for the per-packet fades (one batched draw, ARQ redraws included),
"flip" for ONE 32-bit word per packed element. Bit plane b of a
codeword flips iff fmix32(word ^ (b+1)*GOLDEN) < p * 2^32. The
per-leaf reference (`impl="per_leaf"`) consumes the same words and
fades, so it is bit-identical to the packed path.

Route: a nearest-rounding packed send calls the quant_channel wrapper
(`kernels/quant_channel/ops.py`), which launches the hand-written CUDA
kernel for CUDA tensors and runs the plain version for CPU tensors,
whatever `impl` says ("packed" and "kernel" are the same function,
bit-identical in the JAX package too). `rounding="stochastic"` runs the
plain version on any device: only it implements stochastic rounding.
The route is fixed by (device, rounding) before the call; a build or
launch error propagates.

Bit work is in int64 masked to 32 bits: torch on the CPU has no `>>`
or `<` on uint32, and an int64 product of two 32-bit values can
overflow, so `_mul32` splits the multiplier.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import quantization as Q
from repro_torch.nn.core import tree_leaves, tree_map, tree_unflatten

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # per-bit-plane salt stride
_GE_FOLD = 77        # the JAX package's fold for the Gilbert-Elliott chain
_SR_SALT = (33 * GOLDEN) & M32  # stochastic-rounding salt (plane 33)
WIRE_COLS = 256      # packed row width
_ROW_ALIGN = 8       # R padded to a multiple of this


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 on int64 words holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def bit_flip_mask(rand: torch.Tensor, n_bits: int, p) -> torch.Tensor:
    """XOR mask with each of the low `n_bits` planes set iid w.p. `p`,
    from ONE 32-bit word per element; `p` (float32) broadcasts against
    `rand`. The threshold is float32 p * 2^32 truncated, as in JAX."""
    thresh = (torch.as_tensor(p, dtype=torch.float32)
              * 4294967296.0).to(torch.int64)
    flips = torch.zeros_like(rand)
    for b in range(n_bits):
        salt = ((b + 1) * GOLDEN) & M32
        r = fmix32(rand ^ salt)
        flips = flips | ((r < thresh).to(torch.int64) << b)
    return flips


# ---------------------------------------------------------------- manifest
@dataclasses.dataclass(frozen=True)
class WirePlan:
    """Static packed-buffer layout for one tree."""
    treedef: Any               # the tree with its leaves set to None
    shapes: tuple              # per-packet logical shapes
    dtypes: tuple              # per-packet torch dtype
    sizes: tuple               # per-packet element counts
    rows: tuple                # per-packet row counts
    row_start: tuple           # per-packet first row
    cols: int
    n_rows: int                # R, padded to a multiple of _ROW_ALIGN

    @property
    def n_packets(self) -> int:
        return len(self.shapes)


def _plan_from_shapes(treedef, shapes, dtypes, cols: int) -> WirePlan:
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    rows = tuple(-(-s // cols) for s in sizes)
    starts, acc = [], 0
    for r in rows:
        starts.append(acc)
        acc += r
    n_rows = max(_ROW_ALIGN, -(-acc // _ROW_ALIGN) * _ROW_ALIGN)
    return WirePlan(treedef, tuple(tuple(s) for s in shapes), tuple(dtypes),
                    sizes, rows, tuple(starts), cols, n_rows)


def _treedef(tree):
    return tree_map(lambda _: None, tree)


def plan_for(tree, cols: int = WIRE_COLS) -> WirePlan:
    """Layout plan treating every leaf of `tree` as one packet."""
    leaves = tree_leaves(tree)
    return _plan_from_shapes(_treedef(tree),
                             tuple(tuple(l.shape) for l in leaves),
                             tuple(l.dtype for l in leaves), cols)


def _row_ids(plan: WirePlan) -> np.ndarray:
    """Static row -> packet-id map (final padding rows alias packet 0;
    they hold zeros and their output is discarded at unpack)."""
    ids = np.zeros(plan.n_rows, np.int64)
    for i, (r0, r) in enumerate(zip(plan.row_start, plan.rows)):
        ids[r0:r0 + r] = i
    return ids


def _pack_leaves(leaves, plan: WirePlan) -> torch.Tensor:
    """Leaves with a leading batch axis [n, *shape_i] -> [n, R, cols]."""
    n = leaves[0].shape[0]
    buf = torch.zeros((n, plan.n_rows * plan.cols), dtype=torch.float32,
                      device=leaves[0].device)
    for leaf, size, r0 in zip(leaves, plan.sizes, plan.row_start):
        off = r0 * plan.cols
        buf[:, off:off + size] = leaf.reshape(n, -1).float()
    return buf.reshape(n, plan.n_rows, plan.cols)


def _unpack_leaves(buf: torch.Tensor, plan: WirePlan) -> list:
    """[n, R, cols] -> leaves [n, *shape_i] (padding dropped, dtypes
    restored)."""
    n = buf.shape[0]
    flat = buf.reshape(n, -1)
    out = []
    for shape, dt, size, r0 in zip(plan.shapes, plan.dtypes, plan.sizes,
                                   plan.row_start):
        off = r0 * plan.cols
        out.append(flat[:, off:off + size].reshape((n,) + shape).to(dt))
    return out


def pack_tree(tree, cols: int = WIRE_COLS):
    """-> (packed [R, cols] float32 buffer, WirePlan)."""
    plan = plan_for(tree, cols)
    return _pack_leaves([l[None] for l in tree_leaves(tree)], plan)[0], plan


def unpack_tree(buf: torch.Tensor, plan: WirePlan):
    """Inverse of pack_tree (padding discarded, dtypes restored)."""
    return tree_unflatten(plan.treedef,
                          [l[0] for l in _unpack_leaves(buf[None], plan)])


# ----------------------------------------------------------------- faults
def fault_free(fading: bool = True, perfect: bool = False,
               arq_attempts: int = 1, arq_min_f2: float = 0.25,
               arq_max_tx: int = 0, ge_p_gb: float = 0.0) -> bool:
    """True iff this knob combination can neither retransmit nor erase."""
    if perfect:
        return True
    if ge_p_gb > 0.0:
        return False
    if arq_max_tx > 0:
        return (not fading) and arq_min_f2 <= 1.0
    return (not fading) or arq_attempts <= 1


def _ge_bad_states(draws, n: int, n_packets: int, p_gb: float, p_bg: float):
    """[n, n_packets] bool bad-link states of the two-state
    Gilbert-Elliott chain (initial state from the stationary law)."""
    pi_bad = p_gb / max(p_gb + p_bg, 1e-12)
    bad = draws.uniform("ge_init", (n,), 0.0, 1.0) < pi_bad
    us = draws.uniform("ge_chain", (n_packets, n), 0.0, 1.0)
    out = []
    for t in range(n_packets):
        bad = torch.where(bad, us[t] >= p_bg, us[t] < p_gb)
        out.append(bad)
    return torch.stack(out, dim=1)


def backoff_s(n_tx, base_s: float):
    """Exponential-backoff wait of packets that took `n_tx`
    transmissions: base * (2^(k-1) - 1) each, summed (host f64)."""
    if base_s <= 0.0:
        return 0.0
    k = np.asarray(n_tx, np.float64)
    return float(base_s) * float(np.sum(np.exp2(k - 1.0) - 1.0))


def expected_arq_tx(attempts: int = 1, min_f2: float = 0.25,
                    fading: bool = True, perfect: bool = False) -> float:
    """Analytic expected transmissions per packet under outage-ARQ."""
    if attempts <= 1 or not fading or perfect:
        return 1.0
    p_out = 1.0 - math.exp(-min_f2)
    return (1.0 - p_out ** attempts) / (1.0 - p_out)


def _packet_fades(draws, n: int, n_packets: int, fading: bool,
                  arq_attempts: int, arq_min_f2: float,
                  arq_max_tx: int = 0, ge_p_gb: float = 0.0,
                  ge_p_bg: float = 0.5):
    """(|f|^2, n_tx, erased) per (user, packet) from ONE batched "arq"
    uniform draw — `repro.core.wire._packet_fades`."""
    ones = torch.ones((n, n_packets), dtype=torch.int64)
    no_erase = torch.zeros((n, n_packets), dtype=torch.bool)
    if arq_max_tx <= 0 and ge_p_gb <= 0.0:
        if not fading:
            return torch.ones((n, n_packets)), ones, no_erase
        if arq_attempts <= 1:
            u = draws.uniform("arq", (n, n_packets), 1e-12, 1.0)
            return -torch.log(u), ones, no_erase
        attempts = arq_attempts
    else:
        attempts = arq_max_tx if arq_max_tx > 0 else max(int(arq_attempts), 1)
    if fading:
        f2s = -torch.log(draws.uniform("arq", (n, n_packets, attempts),
                                       1e-12, 1.0))
    else:
        f2s = torch.ones((n, n_packets, attempts))
    ok = f2s >= arq_min_f2
    bad = no_erase
    if ge_p_gb > 0.0:
        bad = _ge_bad_states(draws, n, n_packets, ge_p_gb, ge_p_bg)
        ok = ok & ~bad[..., None]
    any_ok = ok.any(dim=-1)
    first = ok.to(torch.int64).argmax(dim=-1)
    idx = torch.where(any_ok, first, attempts - 1)
    n_tx = torch.where(any_ok, first + 1, attempts)
    f2 = torch.gather(f2s, -1, idx[..., None])[..., 0]
    f2 = torch.where(bad & ~any_ok, 0.0, f2)
    erased = (~any_ok) if arq_max_tx > 0 else no_erase
    return f2, n_tx, erased


def drawn_stacked_tx(draws, n: int, n_packets: int, fading: bool = True,
                     perfect: bool = False, arq_attempts: int = 1,
                     arq_min_f2: float = 0.25, arq_max_tx: int = 0,
                     ge_p_gb: float = 0.0, ge_p_bg: float = 0.5,
                     with_erased: bool = False):
    """Per-(user, packet) DRAWN transmission counts (host [n, n_packets]
    int64 array) of a stacked send, without transmitting; with
    `with_erased`, also the bool erasure mask."""
    if fault_free(fading, perfect, arq_attempts, arq_min_f2, arq_max_tx,
                  ge_p_gb):
        n_tx = np.ones((n, n_packets), np.int64)
        return (n_tx, np.zeros((n, n_packets), bool)) if with_erased \
            else n_tx
    _, n_tx, erased = _packet_fades(draws, n, n_packets, fading,
                                    arq_attempts, arq_min_f2, arq_max_tx,
                                    ge_p_gb, ge_p_bg)
    n_tx = n_tx.numpy()
    return (n_tx, erased.numpy()) if with_erased else n_tx


# --------------------------------------------------------------- accounting
def wire_width(wire_dtype: str, bits: int) -> int:
    """Billed on-air bits per codeword for a wire dtype."""
    if wire_dtype == "int8":
        return 8
    if wire_dtype == "int4":
        return 4
    return int(bits)


def payload_bits(tree, bits: int, expected_tx: float = 1.0,
                 wire_dtype: str = "float32") -> float:
    """On-air payload of transmitting every leaf of `tree` (a tensor, a
    list of tensors or a tree) at b-bit codewords, billed at the wire
    container width (`wire_width`) and scaled by the expected (ARQ)
    transmission count."""
    leaves = list(tree) if isinstance(tree, (list, tuple)) \
        else tree_leaves(tree)
    n = sum(int(np.size(t)) if not torch.is_tensor(t) else t.numel()
            for t in leaves)
    return float(n) * float(wire_width(wire_dtype, bits)) \
        * float(expected_tx)


def drawn_tree_tx(draws, n_packets: int = 1, fading: bool = True,
                  perfect: bool = False, arq_attempts: int = 1,
                  arq_min_f2: float = 0.25, arq_max_tx: int = 0,
                  ge_p_gb: float = 0.0, ge_p_bg: float = 0.5) -> int:
    """Total DRAWN transmissions of a `transmit_tree(draws, tree)` call
    whose tree has `n_packets` leaves, without transmitting: the
    fade/ARQ redraw is the "arq" draw alone, so a replay bills exactly
    what the crossing drew."""
    return drawn_tree_diag(draws, n_packets, fading, perfect, arq_attempts,
                           arq_min_f2, arq_max_tx, ge_p_gb, ge_p_bg)[0]


def drawn_tree_diag(draws, n_packets: int = 1, fading: bool = True,
                    perfect: bool = False, arq_attempts: int = 1,
                    arq_min_f2: float = 0.25, arq_max_tx: int = 0,
                    ge_p_gb: float = 0.0, ge_p_bg: float = 0.5):
    """(n_tx_sum, n_erased, backoff_units) of a `transmit_tree` draw,
    without transmitting; (n_packets, 0, 0.0) when `fault_free`.
    Backoff units are the float32 sum over packets of 2^(n_tx-1) - 1."""
    if fault_free(fading, perfect, arq_attempts, arq_min_f2, arq_max_tx,
                  ge_p_gb):
        return int(n_packets), 0, 0.0
    _, n_tx, erased = _packet_fades(draws, 1, n_packets, fading,
                                    arq_attempts, arq_min_f2, arq_max_tx,
                                    ge_p_gb, ge_p_bg)
    bo = torch.exp2((n_tx - 1).float()) - 1.0
    return int(n_tx.sum()), int(erased.sum()), float(bo.sum())


# ------------------------------------------------------------ fused channel
def wire_transform(buf: torch.Tensor, rand: torch.Tensor, scale, p,
                   bits: int, code_dtype: str = "uint32",
                   stochastic: bool = False,
                   nibble_packed: bool = False) -> torch.Tensor:
    """The fused quantize -> BPSK/Rayleigh bit-flip -> dequantize math on
    a packed buffer; `rand` holds one 32-bit word per element (int64),
    `scale`/`p` broadcast against `buf` (per-row [..., R, 1] vectors).
    The plain version of the quant_channel kernels.

    `code_dtype="uint8"` is the on-wire int8 mode (bits <= 8): the
    codewords live as one byte per element between quantize and
    dequantize. `nibble_packed=True` is the int4 mode (bits <= 4):
    adjacent codeword pairs share one byte, and the flip masks are
    packed the same way. `stochastic=True` rounds stochastically with
    the uniform derived from the same word (salt `_SR_SALT`). All
    modes give the uint32 path's values at the same Q."""
    qm = float(2 ** (bits - 1) - 1)
    x = buf / scale
    if stochastic:
        u = fmix32(rand ^ _SR_SALT).float() * (2.0 ** -32)
        r = Q.stochastic_round(x.float(), u)
    else:
        r = torch.round(x)
    q = Q.to_int32(torch.clamp(r, -qm, qm))     # 2^31 saturates at Q32
    flips = bit_flip_mask(rand, bits, p)
    iqm = int(qm)
    if nibble_packed:
        byte = Q.pack_nibbles(q + iqm) ^ Q.pack_nibbles(flips)
        q_hat = torch.clamp(Q.unpack_nibbles(byte) - iqm, -iqm, iqm)
        return (q_hat.float() * scale).to(buf.dtype)
    if code_dtype == "uint8":
        code = (q + iqm).to(torch.uint8) ^ flips.to(torch.uint8)
        code = code.to(torch.int32)
    else:
        code = ((q.long() + iqm) & M32) ^ flips
        code = torch.where(code >= 2 ** 31, code - 2 ** 32, code)
    # JAX subtracts in int32, which wraps: at 31 bits a code of the
    # negative clip (-qm, offset to 2^32 - 1) with plane 30 flipped
    # lies below -2^31 + qm, and the difference wraps to a positive one
    q_hat = code - iqm
    q_hat = torch.where(q_hat < -2 ** 31, q_hat + 2 ** 32, q_hat)
    q_hat = torch.clamp(q_hat, -iqm, iqm).to(torch.int32)
    return (q_hat.float() * scale).to(buf.dtype)


def _transmit_per_leaf(leaves, plan: WirePlan, rand, p, bits: int):
    """Per-leaf reference loop: per-tensor scale (Q.quantize), the same
    flip words the packed path uses. Bit-exactly the packed output."""
    n = rand.shape[0]
    outs = []
    for ui in range(n):
        row = []
        for i, leaf in enumerate(leaves):
            x = leaf[ui].float()
            q, s = Q.quantize(x, bits)
            code = Q.quantize_offset(q, bits)
            r0, nr, size = plan.row_start[i], plan.rows[i], plan.sizes[i]
            rs = rand[ui, r0:r0 + nr].reshape(-1)[:size].reshape(x.shape)
            code = code ^ bit_flip_mask(rs, bits, p[ui, i])
            q_hat = Q.unquantize_offset(code, bits)
            row.append(Q.dequantize(q_hat, s).to(plan.dtypes[i]))
        outs.append(row)
    return [torch.stack([outs[ui][i] for ui in range(n)])
            for i in range(len(leaves))]


def _link_draws(draws, n: int, plan: WirePlan, snr_db, fading: bool,
                perfect: bool, arq_attempts: int, arq_min_f2: float,
                arq_max_tx: int, ge_p_gb: float, ge_p_bg: float):
    """(p [n, P] float32, n_tx [n, P], erased [n, P]) of one stacked
    send, on the CPU: the fades ("arq"), which the JAX package draws
    before the flip words."""
    npk = plan.n_packets
    if perfect:
        p = torch.zeros((n, npk))
        n_tx = torch.ones((n, npk), dtype=torch.int64)
        erased = torch.zeros((n, npk), dtype=torch.bool)
    else:
        f2, n_tx, erased = _packet_fades(draws, n, npk, fading,
                                         arq_attempts, arq_min_f2,
                                         arq_max_tx, ge_p_gb, ge_p_bg)
        p = torch.as_tensor(draws.bit_error_prob(snr_db, f2),
                            dtype=torch.float32)
    return p, n_tx, erased


def _flip_words(draws, n: int, plan: WirePlan) -> torch.Tensor:
    """The [n, R, C] flip words (int64) of one stacked send."""
    return draws.words("flip", (n, plan.n_rows, plan.cols))


def _flip_words_u32(draws, n: int, plan: WirePlan, device) -> torch.Tensor:
    """The same words as the kernels read them: [n * R, C] int32 bit
    patterns on `device`, converted slab by slab (`Draws.words_u32`)."""
    return draws.words_u32("flip", (n, plan.n_rows, plan.cols),
                           device).view(n * plan.n_rows, plan.cols)


def _scale_rows(leaves, plan: WirePlan, bits: int, row_id):
    """Per-(user, packet) amax scale from the leaves, as [n, R, 1]."""
    amax = torch.stack([l.reshape(l.shape[0], -1).float().abs().amax(1)
                        for l in leaves], dim=1)                  # [n, P]
    return Q.scale_from_amax(amax, bits)[:, row_id][..., None]


def _kernel_rng(device) -> bool:
    from repro_torch.kernels.quant_channel import ops as K
    return K.DEVICE_KERNEL_RNG and device.type == "cuda"


def _transmit_stacked_planned(draws, leaves, plan: WirePlan, bits: int,
                              snr_db, fading: bool, perfect: bool,
                              arq_attempts: int, arq_min_f2: float,
                              impl: str, wire_dtype: str = "float32",
                              arq_max_tx: int = 0, ge_p_gb: float = 0.0,
                              ge_p_bg: float = 0.5,
                              rounding: str = "nearest"):
    """One fused pass over stacked leaves ([N, *shape_i]). Returns
    (received leaves, n_tx [N, P], erased [N, P]); erased packets
    (bounded ARQ exhausted) arrive as zeros."""
    from repro_torch.kernels.quant_channel import ops as K

    n = leaves[0].shape[0]
    dev = leaves[0].device
    # the in-kernel generator (K6, off by default) replaces the words
    kernel_rng = impl != "per_leaf" and rounding == "nearest" \
        and _kernel_rng(dev)
    p, n_tx, erased = _link_draws(
        draws, n, plan, snr_db, fading, perfect, arq_attempts, arq_min_f2,
        arq_max_tx, ge_p_gb, ge_p_bg)
    can_erase = (not perfect) and arq_max_tx > 0
    if impl == "per_leaf":
        out = _transmit_per_leaf(leaves, plan,
                                 _flip_words(draws, n, plan).to(dev),
                                 p.to(dev), bits)
        if can_erase:
            er = erased.to(dev)
            out = [torch.where(er[:, i].reshape((n,) + (1,) * (o.ndim - 1)),
                               torch.zeros((), dtype=o.dtype, device=dev),
                               o) for i, o in enumerate(out)]
        return out, n_tx, erased

    buf = _pack_leaves(leaves, plan)                              # [n, R, C]
    row_id = torch.as_tensor(_row_ids(plan))
    scale_row = _scale_rows(leaves, plan, bits, row_id.to(dev))
    p_row = p[:, row_id][..., None].to(dev)
    r, c = plan.n_rows, plan.cols
    if rounding == "stochastic":
        # only the plain version rounds stochastically (any device)
        y = wire_transform(buf, _flip_words(draws, n, plan).to(dev),
                           scale_row, p_row, bits,
                           code_dtype=("uint8" if wire_dtype == "int8"
                                       else "uint32"),
                           stochastic=True,
                           nibble_packed=(wire_dtype == "int4"))
    elif kernel_rng:
        seed = int(draws.words("kernel_seed", (1,))[0])
        y = K.packed_wire_2d_philox(
            buf.reshape(n * r, c), scale_row.reshape(n * r, 1),
            p_row.reshape(n * r, 1), bits, seed,
            wire_dtype=wire_dtype).reshape(n, r, c)
    else:
        y = K.packed_wire_2d(buf.reshape(n * r, c),
                             _flip_words_u32(draws, n, plan, dev),
                             scale_row.reshape(n * r, 1),
                             p_row.reshape(n * r, 1), bits,
                             wire_dtype=wire_dtype).reshape(n, r, c)
    if can_erase:
        erased_row = erased[:, row_id][..., None].to(dev)
        y = torch.where(erased_row, torch.zeros((), device=dev), y)
    return _unpack_leaves(y, plan), n_tx, erased


def _check_wire_dtype(wire_dtype: str, bits: int, impl: str) -> str:
    if wire_dtype not in ("float32", "int8", "int4"):
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    if wire_dtype != "float32":
        width = 8 if wire_dtype == "int8" else 4
        if bits > width:
            raise ValueError(
                f"{wire_dtype} on-wire dtype holds at most {width}-bit "
                f"codewords, got quant_bits={bits}")
        if impl not in ("packed", "kernel"):
            raise ValueError(
                f"wire_dtype={wire_dtype!r} is only implemented for the "
                f"packed and kernel paths, not impl={impl!r}")
    return wire_dtype


def _check_rounding(rounding: str, impl: str) -> str:
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if rounding == "stochastic" and impl != "packed":
        raise ValueError(
            "rounding='stochastic' is only implemented for the packed "
            f"path, not impl={impl!r} (the kernel and the per-leaf "
            "reference round to nearest)")
    return rounding


def _check_impl(impl: str) -> str:
    if impl not in ("packed", "kernel", "per_leaf"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def transmit_stacked(draws, tree, bits: int, snr_db, fading: bool = True,
                     perfect: bool = False, arq_attempts: int = 1,
                     arq_min_f2: float = 0.25, impl: str = "packed",
                     return_diag: bool = False,
                     wire_dtype: str = "float32", arq_max_tx: int = 0,
                     ge_p_gb: float = 0.0, ge_p_bg: float = 0.5,
                     rounding: str = "nearest"):
    """Fused transmit of a tree whose leaves carry a leading user axis
    [N, ...]: each (user, leaf) pair is one packet with its own fade
    and per-tensor scale — FL's whole N-user upload in one pass (one
    kernel launch on the card). With return_diag=True also returns
    {"n_tx": [N, P] int64, "erased": [N, P] bool} (CPU tensors): the
    DRAWN per-packet transmission counts and the bounded-ARQ erasure
    mask. Knobs as in the JAX package's `transmit_stacked`."""
    leaves = tree_leaves(tree)
    if not leaves:
        return (tree, {"n_tx": torch.zeros((1, 0), dtype=torch.int64),
                       "erased": torch.zeros((1, 0), dtype=torch.bool)}) \
            if return_diag else tree
    plan = _plan_from_shapes(_treedef(tree),
                             tuple(tuple(l.shape[1:]) for l in leaves),
                             tuple(l.dtype for l in leaves), WIRE_COLS)
    impl = _check_impl(impl)
    out, n_tx, erased = _transmit_stacked_planned(
        draws, leaves, plan, int(bits), snr_db, bool(fading), bool(perfect),
        int(arq_attempts), float(arq_min_f2), impl,
        wire_dtype=_check_wire_dtype(wire_dtype, int(bits), impl),
        arq_max_tx=int(arq_max_tx), ge_p_gb=float(ge_p_gb),
        ge_p_bg=float(ge_p_bg), rounding=_check_rounding(rounding, impl))
    rx = tree_unflatten(plan.treedef, out)
    return (rx, {"n_tx": n_tx, "erased": erased}) if return_diag else rx


def transmit_tree(draws, tree, bits: int, snr_db, fading: bool = True,
                  perfect: bool = False, arq_attempts: int = 1,
                  arq_min_f2: float = 0.25, impl: str = "packed",
                  return_diag: bool = False, wire_dtype: str = "float32",
                  arq_max_tx: int = 0, ge_p_gb: float = 0.0,
                  ge_p_bg: float = 0.5, rounding: str = "nearest"):
    """Fused transmit of a tree (or one tensor): one fade + one
    per-tensor scale per leaf, one pass for the whole tree. With
    return_diag=True also returns {"n_tx": [P], "erased": [P]}."""
    leaves = tree_leaves(tree)
    if not leaves:
        return (tree, {"n_tx": torch.zeros((0,), dtype=torch.int64),
                       "erased": torch.zeros((0,), dtype=torch.bool)}) \
            if return_diag else tree
    stacked = tree_map(lambda l: l[None], tree)
    rx, diag = transmit_stacked(
        draws, stacked, bits, snr_db, fading, perfect, arq_attempts,
        arq_min_f2, impl, True, wire_dtype, arq_max_tx, ge_p_gb, ge_p_bg,
        rounding)
    rx = tree_map(lambda l: l[0], rx)
    return (rx, {"n_tx": diag["n_tx"][0], "erased": diag["erased"][0]}) \
        if return_diag else rx


def transmit_stacked_mean(draws, tree, bits: int, snr_db,
                          fading: bool = True, perfect: bool = False,
                          arq_attempts: int = 1, arq_min_f2: float = 0.25,
                          impl: str = "kernel",
                          wire_dtype: str = "float32", arq_max_tx: int = 0,
                          ge_p_gb: float = 0.0, ge_p_bg: float = 0.5):
    """Fused transmit-and-aggregate of a stacked [N, ...] upload: what
    `transmit_stacked` + the alive-weighted mean would give, without the
    received [N, ...] tree. Returns (mean tree with UNstacked leaves,
    {"n_tx", "erased", "n_alive"}). Weights are 1/n_alive over users
    with no erased packet; all erased gives zeros and n_alive 0. Users
    accumulate in ascending order, each product rounded before its add
    (one kernel launch on the card) — allclose, not bitwise, to
    dequantize-then-mean."""
    from repro_torch.kernels.quant_channel import ops as K

    leaves = tree_leaves(tree)
    if not leaves:
        return tree, {"n_tx": torch.zeros((1, 0), dtype=torch.int64),
                      "erased": torch.zeros((1, 0), dtype=torch.bool),
                      "n_alive": 0}
    if impl not in ("packed", "kernel"):
        raise ValueError(f"transmit_stacked_mean: unknown impl {impl!r}")
    wire_dtype = _check_wire_dtype(wire_dtype, int(bits), impl)
    plan = _plan_from_shapes(_treedef(tree),
                             tuple(tuple(l.shape[1:]) for l in leaves),
                             tuple(l.dtype for l in leaves), WIRE_COLS)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    p, n_tx, erased = _link_draws(
        draws, n, plan, snr_db, bool(fading), bool(perfect),
        int(arq_attempts), float(arq_min_f2), int(arq_max_tx),
        float(ge_p_gb), float(ge_p_bg))
    can_erase = (not perfect) and arq_max_tx > 0
    alive = ~erased.any(dim=1) if can_erase \
        else torch.ones((n,), dtype=torch.bool)
    n_alive = int(alive.sum())
    w = alive.float() / max(n_alive, 1)                             # [N]
    buf = _pack_leaves(leaves, plan)
    row_id = torch.as_tensor(_row_ids(plan))
    scale_row = _scale_rows(leaves, plan, int(bits), row_id.to(dev))
    p_row = p[:, row_id][..., None].to(dev)
    r, c = plan.n_rows, plan.cols
    w_row = w[:, None, None].expand(n, r, 1).reshape(n * r, 1).to(dev)
    acc = K.packed_wire_mean_2d(
        buf.reshape(n * r, c), _flip_words_u32(draws, n, plan, dev),
        scale_row.reshape(n * r, 1), p_row.reshape(n * r, 1), w_row,
        int(bits), n, wire_dtype=wire_dtype)
    out = tree_unflatten(plan.treedef,
                         [l[0] for l in _unpack_leaves(acc[None], plan)])
    return out, {"n_tx": n_tx, "erased": erased, "n_alive": n_alive}
