"""The injection seam for the channel's random numbers.

The JAX package draws its fades, ARQ redraws and flip words from
threefry keys; torch's generators give other numbers from the same
seed. So every random draw of the port's channel goes through a
`Draws` object by NAME, and a caller can hand in the reference's own
draws (the parity tests do). The names a send uses:

  "fade"      [n_rows] uniforms in [1e-12, 1)   per-row Rayleigh fade
  "flip"      [*tokens.shape] 32-bit words      bit-plane flip hashes
  "arq"       [n, n_packets, attempts] uniforms bounded-ARQ redraws
  "ge_init"   [n] uniforms                      Gilbert-Elliott start
  "ge_chain"  [n_packets, n] uniforms           Gilbert-Elliott steps

Words are int64 tensors holding values in [0, 2^32): torch has no
`>>` or `<` on uint32 on the CPU, so bit work is done in int64 masked
to 32 bits.
"""
from __future__ import annotations

import torch


class Draws:
    """Default source: one seeded `torch.Generator` on the CPU, drawn in
    call order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, name: str, shape, lo: float, hi: float):
        u = torch.rand(tuple(shape), generator=self.generator,
                       dtype=torch.float32)
        return (u * (hi - lo) + lo).clamp(lo, hi)

    def words(self, name: str, shape):
        return torch.randint(0, 1 << 32, tuple(shape),
                             generator=self.generator, dtype=torch.int64)


def seeded(*ints: int) -> Draws:
    """`Draws` on a generator seeded from a tuple of integers (stream,
    request, leg, attempt, ...), so each crossing gets its own stream."""
    g = torch.Generator(device="cpu")
    seed = 0
    for i in ints:
        seed = (seed * 1_000_003 + int(i) + 1) % (1 << 63)
    g.manual_seed(seed)
    return Draws(g)
