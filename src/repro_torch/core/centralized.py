"""Centralized learning helpers — the part of `repro/core/centralized.py`
the serving uplink needs."""
from __future__ import annotations


def token_bits(vocab_size: int) -> int:
    """Fixed-width codeword size of one raw token id on the CL uplink."""
    return max(1, (int(vocab_size) - 1).bit_length())
