"""The JAX package's random streams behind the port's seams, for the
port's parity tests (tests/test_torch_*.py). `JaxKey` stands in for the
port's `core.draws.Key`: it folds like a JAX key, and its `draws()`
answer each draw name with the numbers the JAX package draws from that
key for one crossing — (kf, kb) = split(key); fades ("fade", "arq")
from kf, the flip words ("flip") from kb, the Gilbert-Elliott chain
from split(fold_in(kf, 77)), normals ("normal", "jitter") from the key
itself — and each packet's bit error probability with the JAX package's
own float32 erfc. A FaultPlan's uniforms ("fault_outage",
"fault_dropout", "fault_frac") are the three children of split(key, 3);
participation is `jax.random.choice(key, n, (k,), replace=False)` or
`jax.random.bernoulli(key, p, (n,))`. `split(n)` is `jax.random.split`.
`JaxServeDraws` hands the JAX serving engine's draws to the port's
`ServeEngine`, `JaxLegacyDraws` the JAX static serving loop's to the
port's `legacy_loop`. `port_train_state` and `port_pop_state` turn the
JAX package's initial states into the port's; `scaled_on_init` hands a
port `Experiment` the initial weights of a JAX scaled scheme."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import channel as JCH
from repro.core import wire as JW
from repro_torch.core import federated as FED
from repro_torch.launch.serve import PROMPT as LEGACY_PROMPT
from repro_torch.serve.engine import SERVE_STREAM


class JaxDraws:
    def __init__(self, key):
        self.key = key

    FAULT_NAMES = ("fault_outage", "fault_dropout", "fault_frac")

    def _key(self, name):
        if name in self.FAULT_NAMES:
            return jax.random.split(self.key, 3)[
                self.FAULT_NAMES.index(name)]
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

    def words_u32(self, name, shape, device):
        w = jax.random.bits(self._key(name), tuple(shape), jnp.uint32)
        return torch.from_numpy(
            np.asarray(w).view(np.int32).copy()).to(device)

    def normal(self, name, shape):
        """jax.random.normal of the key itself (core/dp.py draws one
        leaf's noise per child key of `JaxKey.split`)."""
        return torch.from_numpy(np.array(jax.random.normal(
            self.key, tuple(shape), jnp.float32)))

    def choice(self, name, n, k):
        return torch.from_numpy(np.array(jax.random.choice(
            self.key, n, (k,), replace=False)))

    def bernoulli(self, name, p, shape):
        return torch.from_numpy(np.array(jax.random.bernoulli(
            self.key, p, tuple(shape))))

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

    def split(self, n: int) -> list:
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def draws(self) -> JaxDraws:
        return JaxDraws(self.key)


# ------------------------------------------- the JAX serving engine's draws
class JaxLinkDraws:
    """The port's `Draws` interface answered with the numbers the JAX
    package draws from `key` for one `send_tokens` crossing:
    `transmit_tokens` splits the key into (fade, flip) and the bounded
    ARQ draw folds 4242, then splits (and folds 77 for Gilbert-Elliott).
    """

    def __init__(self, key, arq_key=None):
        self.key = key
        self.arq_key = arq_key if arq_key is not None \
            else jax.random.fold_in(key, 4242)

    def _key(self, name):
        if name == "fade":
            return jax.random.split(self.key)[0]
        if name == "flip":
            return jax.random.split(self.key)[1]
        kf = jax.random.split(self.arq_key)[0]      # drawn_stacked_tx's
        if name == "arq":
            return kf
        k0, kc = jax.random.split(jax.random.fold_in(kf, JW._GE_FOLD))
        return {"ge_init": k0, "ge_chain": kc}[name]

    def uniform(self, name, shape, lo, hi):
        u = jax.random.uniform(self._key(name), tuple(shape), jnp.float32,
                               lo, hi)
        return torch.from_numpy(np.array(u))

    def words(self, name, shape):
        w = jax.random.bits(self._key(name), tuple(shape), jnp.uint32)
        return torch.from_numpy(np.asarray(w).astype(np.int64))

    def words_u32(self, name, shape, device):
        w = jax.random.bits(self._key(name), tuple(shape), jnp.uint32)
        return torch.from_numpy(
            np.asarray(w).view(np.int32).copy()).to(device)


class JaxServeDraws:
    """The JAX engine's serving draws (module docstring of
    repro/serve/engine.py): kreq = fold_in(PRNGKey(seed + 13), rid);
    prompt fold 3, uplink fold 1, downlink fold 2 (then the attempt),
    sampling fold 9 (then the token index)."""

    def __init__(self, seed):
        self.base = jax.random.PRNGKey(seed + SERVE_STREAM)

    def _req(self, rid):
        return jax.random.fold_in(self.base, rid)

    def prompt(self, rid, n, vocab):
        return np.asarray(jax.random.randint(
            jax.random.fold_in(self._req(rid), 3), (n,), 1, vocab,
            jnp.int32))

    def link(self, rid, leg, attempt):
        return JaxLinkDraws(jax.random.fold_in(
            jax.random.fold_in(self._req(rid), leg), attempt))

    def gumbel(self, rid, t, vocab):
        k = jax.random.fold_in(jax.random.fold_in(self._req(rid), 9), t)
        return torch.from_numpy(np.array(
            jax.random.gumbel(k, (vocab,), jnp.float32)))


# ------------------------------------------------ the JAX package's states
def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def port_train_state(js):
    """A JAX TrainState of one user as the port's (SGD-momentum or
    AdamW optimizer state)."""
    from repro_torch.optim import AdamWState, SGDState
    from repro_torch.runtime.train_step import TrainState
    ost = js.opt_state
    step = int(np.asarray(ost.step).reshape(-1)[0])
    if hasattr(ost, "mu"):
        opt = AdamWState(_torch_tree(ost.mu), _torch_tree(ost.nu), step)
    else:
        opt = SGDState(_torch_tree(ost.velocity), step)
    return TrainState(_torch_tree(js.trainable), opt,
                      int(np.asarray(js.step).reshape(-1)[0]))


def port_pop_state(jpop, like):
    """The JAX PopulationScheme's initial `_PopState` as the port's
    (`like`, the port's own initial one, gives the group sizes)."""
    groups = [FED.broadcast_state(port_train_state(jax.tree.map(
        lambda a: a[0], g)), int(jax.tree.leaves(g)[0].shape[0]))
        for g in jpop.groups]
    assert len(groups) == len(like.groups)
    return dataclasses.replace(
        like, groups=groups,
        sl_states=[port_train_state(s) for s in jpop.sl_states],
        cl_states=[port_train_state(s) for s in jpop.cl_states],
        global_trainable=_torch_tree(jpop.global_trainable))


def scaled_on_init(jscheme, xtr, ytr):
    """`Experiment.on_init` handing the port the JAX scheme's weights."""
    def hook(state):
        jstate, _ = jscheme.init(0, xtr, ytr)
        train = jstate.train
        if jscheme.mode == "fl":
            one = port_train_state(jax.tree.map(lambda a: a[0], train))
            train = FED.broadcast_state(one, jscheme.n_users)
        else:
            train = port_train_state(train)
        return dataclasses.replace(state, train=train)
    return hook


class JaxLegacyDraws:
    """The JAX static loop's draws behind the port's `LegacyDraws`
    seams: everything folds PRNGKey(seed)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def prompt(self, shape, vocab):
        return torch.from_numpy(np.array(jax.random.randint(
            jax.random.fold_in(self.key, LEGACY_PROMPT), tuple(shape), 1,
            vocab, jnp.int32)))

    def link(self, fold):
        return JaxLinkDraws(jax.random.fold_in(self.key, fold))

    def gumbel(self, fold, shape):
        return torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(self.key, fold), tuple(shape), jnp.float32)))
