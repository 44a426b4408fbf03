"""Channel coding — the port of `repro/core/coding.py` (beyond-paper
extension #1).

The paper transmits uncoded BPSK; a Hamming(7,4) code corrects every
single-bit error per 7-bit block at a 7/4 bandwidth cost, which beats
uncoded transmission whenever the raw BER is above ~1e-3 (low SNR or
deep Rayleigh fades). Everything is table lookups in plain integer ops
(the JAX package has no kernel here): 4-bit nibbles -> 16 codewords,
7-bit received words -> syndrome-corrected nibbles. Codewords are int64
tensors holding unsigned values, as in core/quantization.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import channel as CH
from repro_torch.core import quantization as Q

# generator for systematic Hamming(7,4): data bits d3..d0, parity p2..p0
_G_ROWS = np.array([
    [1, 0, 0, 0, 0, 1, 1],
    [0, 1, 0, 0, 1, 0, 1],
    [0, 0, 1, 0, 1, 1, 0],
    [0, 0, 0, 1, 1, 1, 1],
], np.uint8)


@functools.lru_cache(maxsize=1)
def _np_tables():
    enc = np.zeros(16, np.uint8)
    for d in range(16):
        bits = np.array([(d >> i) & 1 for i in range(4)], np.uint8)
        cw = bits @ _G_ROWS % 2
        enc[d] = int("".join(map(str, cw[::-1])), 2)
    # decode: for each 7-bit word, the nibble of the nearest codeword
    dec = np.zeros(128, np.uint8)
    cw_bits = np.unpackbits(enc[:, None], axis=1, count=8)[:, 1:]
    for w in range(128):
        wb = np.array([(w >> i) & 1 for i in range(6, -1, -1)], np.uint8)
        dists = (cw_bits ^ wb).sum(1)
        dec[w] = int(np.argmin(dists))
    return enc, dec


def _tables(device) -> tuple:
    enc, dec = _np_tables()
    return (torch.from_numpy(enc.astype(np.int64)).to(device),
            torch.from_numpy(dec.astype(np.int64)).to(device))


def hamming_encode(codewords: torch.Tensor, bits: int) -> tuple:
    """Pack b-bit codewords into ceil(b/4) Hamming(7,4) blocks.
    Returns (coded int64 tensor [..., n_blocks], coded bits per word)."""
    enc, _ = _tables(codewords.device)
    n_blk = -(-bits // 4)
    nibbles = torch.stack([(codewords.long() >> (4 * i)) & 0xF
                           for i in range(n_blk)], dim=-1)
    return enc[nibbles], n_blk * 7


def hamming_decode(blocks: torch.Tensor, bits: int) -> torch.Tensor:
    _, dec = _tables(blocks.device)
    n_blk = blocks.shape[-1]
    nibbles = dec[blocks.long() & 0x7F]
    out = torch.zeros(blocks.shape[:-1], dtype=torch.int64,
                      device=blocks.device)
    for i in range(n_blk):
        out = out | (nibbles[..., i] << (4 * i))
    return out & (2 ** bits - 1)


def transmit_quantized_coded(draws, x: torch.Tensor, bits: int,
                             snr_db: float, fading: bool = True):
    """Quantize -> Hamming(7,4) -> BPSK/Rayleigh channel -> correct ->
    dequantize, on `draws` ("fade": one Rayleigh draw, "flip": one word
    per block; p from `draws.bit_error_prob`). Returns (x_hat,
    payload_bits): the payload includes the 7/4 parity overhead."""
    q, s = Q.quantize(x, bits, scale=Q.scale_divided(x, bits))
    code = Q.quantize_offset(q, bits)
    blocks, coded_bits = hamming_encode(code, bits)
    f2 = CH.rayleigh_gain(draws) if fading \
        else torch.tensor(1.0, dtype=torch.float32)
    p = draws.bit_error_prob(snr_db, f2).to(x.device)
    blocks = CH.flip_bits(draws, blocks, 7, p)
    code_hat = hamming_decode(blocks, bits)
    q_hat = Q.unquantize_offset(code_hat, bits)
    return Q.dequantize(q_hat, s, x.dtype), int(x.numel()) * coded_bits


def block_error_prob(p_bit, corrected: bool = True):
    """P(7-bit block decodes wrong): uncorrected = 1-(1-p)^7;
    Hamming corrects single errors: 1 - (1-p)^7 - 7 p (1-p)^6."""
    q = (1.0 - p_bit) ** 7
    if not corrected:
        return 1.0 - q
    return 1.0 - q - 7.0 * p_bit * (1.0 - p_bit) ** 6
