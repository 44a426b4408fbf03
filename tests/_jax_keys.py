"""The JAX package's random streams behind the port's seams, for the
port's parity tests (tests/test_torch_*.py). `JaxKey` stands in for the
port's `core.draws.Key`: it folds like a JAX key, and its `draws()`
answer each draw name with the numbers the JAX package draws from that
key for one crossing — (kf, kb) = split(key); fades ("fade", "arq")
from kf, the flip words ("flip") from kb, the Gilbert-Elliott chain
from split(fold_in(kf, 77)) — and each packet's bit error probability
with the JAX package's own float32 erfc."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import channel as JCH
from repro.core import wire as JW


class JaxDraws:
    def __init__(self, key):
        self.key = key

    def _key(self, name):
        kf, kb = jax.random.split(self.key)
        if name in ("fade", "arq"):
            return kf
        if name == "flip":
            return kb
        k0, kc = jax.random.split(jax.random.fold_in(kf, JW._GE_FOLD))
        return {"ge_init": k0, "ge_chain": kc}[name]

    def uniform(self, name, shape, lo, hi):
        u = jax.random.uniform(self._key(name), tuple(shape), jnp.float32,
                               lo, hi)
        return torch.from_numpy(np.array(u))

    def words(self, name, shape):
        w = jax.random.bits(self._key(name), tuple(shape), jnp.uint32)
        return torch.from_numpy(np.asarray(w).astype(np.int64))

    def bit_error_prob(self, snr_db, f2):
        f2 = np.asarray(f2.cpu() if torch.is_tensor(f2) else f2,
                        np.float32)
        return torch.from_numpy(np.array(
            JCH.bpsk_bit_error_prob(snr_db, jnp.asarray(f2))))


class JaxKey:
    def __init__(self, key):
        self.key = key

    @classmethod
    def root(cls, seed: int) -> "JaxKey":
        return cls(jax.random.PRNGKey(seed))

    def fold_in(self, i: int) -> "JaxKey":
        return JaxKey(jax.random.fold_in(self.key, i))

    def draws(self) -> JaxDraws:
        return JaxDraws(self.key)
