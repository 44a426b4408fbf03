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
  "normal"    [*leaf.shape] standard normals    DP-FedAvg noise (core/dp.py)

Fleets (schemes/faults.py, schemes/population.py) draw on their own
streams under their own names:

  "fault_outage"   [n] uniforms in [0, 1)   whole-cycle outages
  "fault_dropout"  [n] uniforms in [0, 1)   mid-round dropouts
  "fault_frac"     [n] uniforms in [0, 1)   how far a dropout got
  "participation"  k of n indices (`choice`) or [n] bools (`bernoulli`)
  "jitter"         [n] standard normals     deadline compute jitter

The packed wire (core/wire.py) draws "arq" (its per-packet fades, with
or without ARQ), "flip" ([n, R, C] words), the Gilbert-Elliott names
and, behind the in-kernel generator flag, "kernel_seed" (one word).
It also asks the seam for the bit error probability of each packet
(`bit_error_prob`): the float32 erfc of two libraries may differ in the
last ulp, so a caller that must reproduce another implementation's
flips hands in that implementation's p with its draws.

A `Key` names a stream by a path of integers and folds like a JAX key
(`key.fold_in(i)`, and `key.split(n)` for n child streams, as
`jax.random.split`); `key.draws()` is that stream's `Draws`, with one
generator per draw name, so a replay of only the "arq" draw (the SL
billing replay) gets exactly the fades the crossing used.

Words are int64 tensors holding values in [0, 2^32): torch has no
`>>` or `<` on uint32 on the CPU, so bit work is done in int64 masked
to 32 bits.
"""
from __future__ import annotations

import zlib

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

    def _offset_words(self, name: str, n: int) -> torch.Tensor:
        """`words(name, (n,))` minus 2^31, as int32: the same range of
        2^32 values from the same 64-bit draws, half the bytes."""
        return torch.randint(-(1 << 31), 1 << 31, (n,),
                             generator=self.generator, dtype=torch.int32)

    # words drawn and copied at a time by `words_u32`
    WORD_SLAB = 1 << 25

    def words_u32(self, name: str, shape, device) -> torch.Tensor:
        """`words(name, shape)` as the int32 bit patterns the kernels
        read, on `device`. The words are drawn and copied in slabs of
        WORD_SLAB along the flattened shape, so the host holds one slab
        at a time, not the whole draw (a full-width FL sync of
        qwen1.5-0.5b draws 1.39 G words, 11.1 GB as int64). The numbers
        are those of one `words` call: torch fills a CPU tensor from its
        generator serially, one 64-bit draw per value whatever the
        dtype, so consecutive slabs continue one stream, and word w
        drawn as w - 2^31 has w's bit pattern with the top bit flipped,
        which one XOR on `device` restores (tests/test_torch_scaled.py
        holds it to `words`)."""
        out = torch.empty(tuple(shape), dtype=torch.int32, device=device)
        flat = out.view(-1)
        n = flat.numel()
        for i in range(0, n, self.WORD_SLAB):
            m = min(self.WORD_SLAB, n - i)
            flat[i:i + m].copy_(self._offset_words(name, m))
        return out.bitwise_xor_(-(1 << 31))

    def normal(self, name: str, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           dtype=torch.float32)

    def choice(self, name: str, n: int, k: int) -> torch.Tensor:
        """k distinct indices of range(n), in draw order."""
        return torch.randperm(n, generator=self.generator)[:k]

    def bernoulli(self, name: str, p: float, shape) -> torch.Tensor:
        """Bools, each True with probability p."""
        return torch.rand(tuple(shape), generator=self.generator,
                          dtype=torch.float32) < p

    def bit_error_prob(self, snr_db, f2) -> torch.Tensor:
        """p of each packet from its fade: the port's own BPSK formula."""
        from repro_torch.core.channel import bpsk_bit_error_prob
        return bpsk_bit_error_prob(snr_db, f2)


def _mix(ints) -> int:
    seed = 0
    for i in ints:
        seed = (seed * 1_000_003 + int(i) + 1) % (1 << 63)
    return seed


def seeded(*ints: int) -> Draws:
    """`Draws` on a generator seeded from a tuple of integers (stream,
    request, leg, attempt, ...), so each crossing gets its own stream."""
    g = torch.Generator(device="cpu")
    g.manual_seed(_mix(ints))
    return Draws(g)


class KeyDraws(Draws):
    """The `Draws` of one `Key`: each name draws from its own CPU
    generator seeded from (path, name), in call order within the name.
    CPU generators give the same numbers whatever device the consumer
    runs on, so a run on the card and one on the CPU see one stream."""

    def __init__(self, path: tuple):
        self.path = path
        self._gens: dict = {}

    def _gen(self, name: str) -> torch.Generator:
        g = self._gens.get(name)
        if g is None:
            g = torch.Generator(device="cpu")
            g.manual_seed(_mix(self.path + (zlib.crc32(name.encode()),)))
            self._gens[name] = g
        return g

    def uniform(self, name: str, shape, lo: float, hi: float):
        self.generator = self._gen(name)
        return super().uniform(name, shape, lo, hi)

    def words(self, name: str, shape):
        self.generator = self._gen(name)
        return super().words(name, shape)

    def _offset_words(self, name: str, n: int):
        self.generator = self._gen(name)
        return super()._offset_words(name, n)

    def normal(self, name: str, shape):
        self.generator = self._gen(name)
        return super().normal(name, shape)

    def choice(self, name: str, n: int, k: int):
        self.generator = self._gen(name)
        return super().choice(name, n, k)

    def bernoulli(self, name: str, p: float, shape):
        self.generator = self._gen(name)
        return super().bernoulli(name, p, shape)


SPLIT_FOLD = -1     # path element that marks `Key.split`'s children


class Key:
    """A stream named by a path of integers; `fold_in` extends the path
    (the JAX package's `jax.random.fold_in`), `draws()` opens it."""

    def __init__(self, *path: int):
        self.path = tuple(int(i) for i in path)

    def fold_in(self, i: int) -> "Key":
        return Key(*self.path, int(i))

    def split(self, n: int) -> list:
        """`n` child streams, none of them a `fold_in` of this key."""
        return [Key(*self.path, SPLIT_FOLD, i) for i in range(n)]

    def draws(self) -> KeyDraws:
        return KeyDraws(self.path)

    def __repr__(self) -> str:
        return f"Key{self.path}"
