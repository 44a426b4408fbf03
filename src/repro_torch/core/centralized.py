"""Centralized learning baseline: users transmit RAW data to the server
over the channel (the paper's CL); the server trains normally — the port
of `repro/core/centralized.py`. Bit errors corrupt token ids directly."""
from __future__ import annotations

from repro_torch.core import channel as CH
from repro_torch.core import wire as W


def token_bits(vocab_size: int) -> int:
    """Fixed-width codeword size of one raw token id on the CL uplink."""
    return max(1, (int(vocab_size) - 1).bit_length())


def upload_batch(draws, batch: dict, vocab_size: int,
                 wcfg) -> tuple[dict, float]:
    """Send raw tokens through the channel; labels ride a 1-bit control
    channel (errors there ignored, as in the paper). Returns (received
    batch, payload bits) — charged whether or not the link is perfect:
    a perfect channel is noiseless, not free."""
    bits = W.payload_bits(batch["tokens"], token_bits(vocab_size)) \
        + W.payload_bits(batch["labels"], 1)
    if wcfg.perfect_channel:
        return batch, bits
    tokens = CH.transmit_tokens(draws, batch["tokens"], vocab_size,
                                snr_db=wcfg.snr_db, fading=wcfg.fading)
    return dict(batch, tokens=tokens), bits
