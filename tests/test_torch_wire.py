"""Port parity for the packed wire: the port's quantization, wire
transform, packing, transmit paths, bills and the quant_channel
kernels' plain versions are BIT-EXACT against the JAX package (its
Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them), given the JAX package's draws and bit error probabilities
through the port's seams (tests/_jax_keys.py). The port's own p is
pinned within 1e-7 of the JAX package's; the in-kernel generator (K6)
has no CPU path.

Everything runs on the CPU (the wrappers' plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxDraws
from repro.core import channel as JCH
from repro.core import quantization as JQ
from repro.core import wire as JW
from repro.kernels.quant_channel import kernel as JK
from repro.kernels.quant_channel import ops as JOPS
from repro.models import lstm_tiny as JLT
from repro.nn import init_params as jax_init
from repro.schemes.radio import Radio as JRadio
from repro_torch.core import channel as CH
from repro_torch.core import quantization as Q
from repro_torch.core import wire as W
from repro_torch.core.draws import Key
from repro_torch.kernels.quant_channel import ops as K
from repro_torch.kernels.quant_channel import ref as KR
from repro_torch.nn import params_from_jax, tree_leaves
from repro_torch.schemes.radio import Radio
from repro_torch.configs import get_arch

TINY = get_arch("paper-tinylstm")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this file runs: the suite runs
    in several worker processes at once, and torch's spinning thread
    pool slows down by an order of magnitude when they oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    """Bit-exact: same values (and NaN-free), compared as numpy."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(got, np.asarray(want))


def _wire_inputs(seed, rows=16, cols=256, bits=8):
    rng = np.random.default_rng(seed)
    buf = (rng.standard_normal((rows, cols))
           * rng.uniform(0.01, 3.0, (rows, 1))).astype(np.float32)
    buf[0, :5] = 0.0
    rand = rng.integers(0, 2 ** 32, (rows, cols), dtype=np.uint64) \
        .astype(np.uint32)
    amax = np.abs(buf).max(axis=1, keepdims=True)
    scale = (np.maximum(amax, 1e-12) / (2 ** (bits - 1) - 1)) \
        .astype(np.float32)
    p = rng.uniform(0.0, 0.5, (rows, 1)).astype(np.float32)
    p[1] = 0.0
    p[2] = 0.5
    return buf, rand, scale, p


def _torch_words(rand):
    return torch.from_numpy(rand.astype(np.int64))


# ------------------------------------------------------------- quantization
def test_quantization_bit_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 2).astype(np.float32)
    x[:8] = [0.5, -0.5, 1.5, -2.5, 0.0, 127.0, -127.0, 3.5]
    u = rng.uniform(0, 1, 4096).astype(np.float32)
    for bits in (2, 4, 8, 16):
        for uu in (None, u):
            # jitted, as every JAX path that quantizes runs: XLA turns
            # the division by the constant qmax into a product with its
            # reciprocal, which the port repeats
            jq, js = jax.jit(JQ.quantize, static_argnums=1)(
                jnp.asarray(x), bits,
                u=None if uu is None else jnp.asarray(uu))
            q, s = Q.quantize(_t(x), bits,
                              u=None if uu is None else _t(uu))
            _eq(q, jq)
            _eq(s, js)
            _eq(Q.dequantize(q, s), JQ.dequantize(jq, js))
            code = Q.quantize_offset(q, bits)
            _eq(code, JQ.quantize_offset(jq, bits))
            flipped = code ^ 0x8
            _eq(Q.unquantize_offset(flipped, bits),
                JQ.unquantize_offset(jnp.asarray(flipped.numpy())
                                     .astype(jnp.uint32), bits))
    codes = rng.integers(0, 16, (3, 64))
    packed = Q.pack_nibbles(torch.from_numpy(codes))
    _eq(packed, JQ.pack_nibbles(jnp.asarray(codes, jnp.uint32)))
    _eq(Q.unpack_nibbles(packed), codes)


# ------------------------------------------------------------ wire transform
@pytest.mark.parametrize("mode,bits", [
    ("uint32", 8), ("uint32", 16), ("uint32", 3), ("uint32", 31),
    ("uint8", 8),
    ("uint8", 5), ("int4", 4), ("int4", 2), ("stochastic", 8),
    ("stochastic", 4)])
def test_wire_transform_bit_exact(mode, bits):
    buf, rand, scale, p = _wire_inputs(bits, bits=bits)
    kw = dict(code_dtype={"uint8": jnp.uint8}.get(mode, jnp.uint32),
              stochastic=(mode == "stochastic"),
              nibble_packed=(mode == "int4"))
    want = JW.wire_transform(jnp.asarray(buf), jnp.asarray(rand),
                             jnp.asarray(scale), jnp.asarray(p), bits, **kw)
    got = W.wire_transform(_t(buf), _torch_words(rand), _t(scale), _t(p),
                           bits, code_dtype=mode if mode == "uint8"
                           else "uint32",
                           stochastic=(mode == "stochastic"),
                           nibble_packed=(mode == "int4"))
    _eq(got, want)
    assert (got != _t(buf)).any()


def test_fmix_and_flip_mask_bit_exact():
    rng = np.random.default_rng(1)
    rand = rng.integers(0, 2 ** 32, 10_000, dtype=np.uint64) \
        .astype(np.uint32)
    _eq(W.fmix32(_torch_words(rand)), JW.fmix32(jnp.asarray(rand)))
    for p in (0.0, 1e-3, 0.07, 0.5):
        _eq(W.bit_flip_mask(_torch_words(rand), 12, p),
            JW.bit_flip_mask(jnp.asarray(rand), 12, p))


# ------------------------------------------------- kernels' plain versions
@pytest.mark.parametrize("wire_dtype,bits", [("float32", 8),
                                             ("float32", 16),
                                             ("float32", 31),
                                             ("int8", 8), ("int4", 4)])
def test_packed_wire_plain_matches_pallas(wire_dtype, bits):
    """K1's plain version (the wrapper's CPU path) against the Pallas
    kernel in interpret mode, at the SL leg's [224, 256]."""
    buf, rand, scale, p = _wire_inputs(7, rows=224, bits=bits)
    want = JK.packed_wire_2d(jnp.asarray(buf), jnp.asarray(rand),
                             jnp.asarray(scale), jnp.asarray(p), bits,
                             interpret=True, wire_dtype=wire_dtype)
    got = K.packed_wire_2d(_t(buf), _torch_words(rand), _t(scale), _t(p),
                           bits, wire_dtype=wire_dtype)
    _eq(got, want)
    # int32 bit patterns are the same words
    got32 = K.packed_wire_2d(_t(buf), K.words_u32(_torch_words(rand)),
                             _t(scale), _t(p), bits, wire_dtype=wire_dtype)
    _eq(got32, want)


@pytest.mark.parametrize("wire_dtype,bits", [("float32", 8), ("int4", 4)])
def test_packed_wire_mean_plain_matches_pallas(wire_dtype, bits):
    """K2's plain version against the Pallas kernel: 3 users stacked
    along rows, one dead (weight 0)."""
    n, r = 3, 40
    buf, rand, scale, p = _wire_inputs(8, rows=n * r, bits=bits)
    w = np.repeat(np.array([0.5, 0.0, 0.5], np.float32), r)[:, None]
    want = JK.packed_wire_mean_2d(
        jnp.asarray(buf), jnp.asarray(rand), jnp.asarray(scale),
        jnp.asarray(p), jnp.asarray(w), bits, n, interpret=True,
        wire_dtype=wire_dtype)
    got = K.packed_wire_mean_2d(_t(buf), _torch_words(rand), _t(scale),
                                _t(p), _t(w), bits, n,
                                wire_dtype=wire_dtype)
    _eq(got, want)


@pytest.mark.parametrize("shape", [(256, 512), (8, 1024), (1024, 512)])
def test_quant_channel_plain_matches_pallas(shape):
    """K5's plain version (per-tile amax scale, scalar p)."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(shape)
         * rng.uniform(0.1, 9.0, (shape[0], 1))).astype(np.float32)
    rand = rng.integers(0, 2 ** 32, shape, dtype=np.uint64) \
        .astype(np.uint32)
    p = np.array([0.03], np.float32)
    want = JK.quant_channel_2d(jnp.asarray(x), jnp.asarray(rand),
                               jnp.asarray(p), 8, interpret=True)
    _eq(K.quant_channel_2d(_t(x), _torch_words(rand), _t(p), 8), want)


def test_transmit_k5_wrapper_matches_jax():
    """`ops.transmit` of an 89,673-element vector (the paper model's
    parameter count), the JAX package's draws handed in."""
    x = np.random.default_rng(3).standard_normal(89_673) \
        .astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = JOPS.transmit(key, jnp.asarray(x), bits=8, snr_db=5.0,
                         interpret=True)
    got = K.transmit(JaxDraws(key), _t(x), bits=8, snr_db=5.0)
    _eq(got, want)


def test_kernel_rng_has_no_cpu_path_and_philox_is_standard():
    buf = torch.zeros((8, 256))
    with pytest.raises(ValueError, match="CUDA"):
        K.packed_wire_2d_philox(buf, torch.ones((8, 1)),
                                torch.full((8, 1), 0.05), 8, seed=1)
    # Philox4x32-10 known answers (Salmon et al.'s reference vectors)
    m = 0xFFFFFFFF
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((m, m, m, m), (m, m),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))):
        got = KR.philox4x32_10(torch.tensor(ctr, dtype=torch.int64), key)
        assert tuple(int(v) for v in got) == want


# ----------------------------------------------------------- pack / plan
def _jax_tiny_params(seed=0, compress=0):
    return jax_init(jax.random.PRNGKey(seed),
                    JLT.model_specs(None, compress))


def test_plan_and_pack_match_jax():
    jp = _jax_tiny_params()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), TINY, "cpu")
    jplan, plan = JW.plan_for(jp), W.plan_for(tp)
    assert plan.rows == jplan.rows == (1, 3, 1, 2, 313, 1, 16, 16, 1, 1)
    assert plan.row_start == jplan.row_start
    assert plan.sizes == jplan.sizes and plan.shapes == jplan.shapes
    assert plan.n_rows == jplan.n_rows == 360
    np.testing.assert_array_equal(W._row_ids(plan), JW._row_ids(jplan))
    jbuf, _ = JW.pack_tree(jp)
    buf, plan2 = W.pack_tree(tp)
    _eq(buf, jbuf)
    back = W.unpack_tree(buf, plan2)
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- transmits
LINKS = {
    "fading": dict(),
    "no_fading": dict(fading=False),
    "perfect": dict(perfect=True),
    "arq3": dict(arq_attempts=3, arq_min_f2=0.6),
    "bounded_arq": dict(arq_max_tx=2, arq_min_f2=0.7),
    "gilbert_elliott": dict(arq_max_tx=3, ge_p_gb=0.4, ge_p_bg=0.3),
    "ge_unbounded": dict(arq_attempts=2, ge_p_gb=0.5, ge_p_bg=0.5),
    "int8": dict(wire_dtype="int8"),
    "int4": dict(wire_dtype="int4", bits=4),
    "stochastic": dict(rounding="stochastic"),
    "per_leaf": dict(impl="per_leaf"),
}


def _link(name):
    kw = dict(bits=8, snr_db=4.0)
    kw.update(LINKS[name])
    return kw


def _stacked_tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, 300)).astype(np.float32),
            "b": {"w": rng.standard_normal((n, 17, 9)).astype(np.float32),
                  "z": np.zeros((n, 4), np.float32)},
            "c": (rng.standard_normal((n, 2, 128)) * 1e3).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _eq_tree(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        _eq(g, w)


@pytest.mark.parametrize("name", sorted(LINKS))
def test_transmit_stacked_and_tree_bit_exact(name):
    """Every link: the stacked send; a few also as a flat tree and as one
    bare tensor (the SL leg)."""
    kw = _link(name)
    key = jax.random.PRNGKey(5)
    tree = _stacked_tree(3, 1)
    want, wd = JW.transmit_stacked(key, jax.tree.map(jnp.asarray, tree),
                                   return_diag=True, **kw)
    got, gd = W.transmit_stacked(JaxDraws(key), _to_torch(tree),
                                 return_diag=True, **kw)
    _eq_tree(got, want)
    _eq(gd["n_tx"], wd["n_tx"])
    _eq(gd["erased"], wd["erased"])
    if name not in ("fading", "bounded_arq", "perfect", "int4"):
        return
    one = jax.tree.map(lambda a: a[0], tree)
    want1, wd1 = JW.transmit_tree(key, jax.tree.map(jnp.asarray, one),
                                  return_diag=True, **kw)
    got1, gd1 = W.transmit_tree(JaxDraws(key), _to_torch(one),
                                return_diag=True, **kw)
    _eq_tree(got1, want1)
    _eq(gd1["n_tx"], wd1["n_tx"])
    _eq(gd1["erased"], wd1["erased"])
    # one bare tensor is a one-packet tree (the SL leg)
    x = one["a"].reshape(20, 15)
    _eq(W.transmit_tree(JaxDraws(key), torch.from_numpy(x), **kw),
        JW.transmit_tree(key, jnp.asarray(x), **kw))


@pytest.mark.parametrize("name", ["fading", "bounded_arq",
                                  "gilbert_elliott", "int4", "perfect"])
def test_transmit_stacked_mean_bit_exact(name):
    kw = {k: v for k, v in _link(name).items() if k != "rounding"}
    key = jax.random.PRNGKey(6)
    tree = _stacked_tree(3, 2)
    want, wd = JW.transmit_stacked_mean(
        key, jax.tree.map(jnp.asarray, tree), interpret=True, **kw)
    got, gd = W.transmit_stacked_mean(JaxDraws(key), _to_torch(tree), **kw)
    _eq_tree(got, want)
    _eq(gd["n_tx"], wd["n_tx"])
    _eq(gd["erased"], wd["erased"])
    assert gd["n_alive"] == int(wd["n_alive"])


@pytest.mark.parametrize("name", ["fading", "arq3", "bounded_arq",
                                  "gilbert_elliott", "perfect"])
def test_drawn_tree_replay_matches_jax(name):
    kw = {k: v for k, v in _link(name).items()
          if k not in ("bits", "snr_db", "wire_dtype", "impl", "rounding")}
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = JW.drawn_tree_diag(key, 4, **kw)
        got = W.drawn_tree_diag(JaxDraws(key), 4, **kw)
        assert got[0] == int(want[0]) and got[1] == int(want[1])
        assert got[2] == float(want[2])
        assert W.drawn_tree_tx(JaxDraws(key), 4, **kw) == \
            int(JW.drawn_tree_tx(key, 4, **kw))
        # the replay bills exactly what the send drew
        _, diag = W.transmit_tree(JaxDraws(key), _to_torch(
            jax.tree.map(lambda a: a[0], _stacked_tree(1, seed))),
            bits=8, snr_db=4.0, return_diag=True, **kw)
        assert int(diag["n_tx"].sum()) == got[0]


def test_port_key_replay_bills_what_the_send_drew():
    """With the port's own `Key`, the "arq" draw alone replays the
    crossing's counts (one generator per draw name)."""
    kw = dict(arq_max_tx=3, arq_min_f2=0.8, ge_p_gb=0.3)
    tree = _to_torch(jax.tree.map(lambda a: a[0], _stacked_tree(1, 4)))
    for i in range(5):
        key = Key(3, i)
        _, diag = W.transmit_tree(key.draws(), tree, bits=8, snr_db=5.0,
                                  return_diag=True, **kw)
        assert W.drawn_tree_diag(key.draws(), 4, **kw)[:2] == (
            int(diag["n_tx"].sum()), int(diag["erased"].sum()))


# ------------------------------------------------------------------ radio
@pytest.mark.parametrize("name", ["fading", "bounded_arq",
                                  "gilbert_elliott", "int4", "perfect"])
def test_radio_sends_deliver_identically(name):
    kw = _link(name)
    rkw = dict(quant_bits=kw.pop("bits"), snr_db=kw.pop("snr_db"),
               arq_backoff_s=0.01)
    for k in ("fading", "perfect", "arq_attempts", "arq_min_f2",
              "arq_max_tx", "ge_p_gb", "ge_p_bg", "wire_dtype",
              "rounding"):
        if k in kw:
            rkw[k] = kw[k]
    jr, pr = JRadio(**rkw), Radio(**rkw)
    key = jax.random.PRNGKey(8)
    tree = _stacked_tree(3, 3)
    for send in ("send_stacked", "send_tree"):
        t = tree if send == "send_stacked" else \
            jax.tree.map(lambda a: a[0], tree)
        want = getattr(jr, send)(key, jax.tree.map(jnp.asarray, t))
        got = getattr(pr, send)(JaxDraws(key), _to_torch(t))
        _eq_tree(got.payload, want.payload)
        for f in dataclasses.fields(want):
            if f.name != "payload":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.erased_bits <= got.bits
        if got.user_bits is not None:
            assert sum(got.user_bits) == pytest.approx(got.bits)
        if got.user_erased_bits is not None:
            assert sum(got.user_erased_bits) == pytest.approx(
                got.erased_bits)
    n_tx, er = JW.drawn_stacked_tx(key, 3, 4, **{
        k: v for k, v in rkw.items() if k in (
            "fading", "perfect", "arq_attempts", "arq_min_f2", "arq_max_tx",
            "ge_p_gb", "ge_p_bg")}, with_erased=True)
    sizes = [300, 153, 4, 256]
    assert dataclasses.asdict(pr.bill_counts(n_tx, sizes, er)) == \
        dataclasses.asdict(jr.bill_counts(n_tx, sizes, er))
    assert pr.expected_tx() == jr.expected_tx()
    assert pr.wire_width() == jr.wire_width()


def test_channel_transmit_quantized_matches_jax():
    x = np.random.default_rng(4).standard_normal((33, 7)).astype(np.float32)
    for kw in (dict(), dict(arq_attempts=3, arq_min_f2=0.9),
               dict(fading=False), dict(perfect=True)):
        key = jax.random.PRNGKey(12)
        want, wd = jax.jit(JCH.transmit_quantized,
                           static_argnums=(2,),
                           static_argnames=tuple(kw))(
            key, jnp.asarray(x), 8, 3.0, **kw)
        got, gd = CH.transmit_quantized(JaxDraws(key), _t(x), 8, 3.0, **kw)
        _eq(got, want)
        assert int(gd["n_tx"]) == int(wd["n_tx"])


# ------------------------------------------------------------ the erfc gap
def test_port_bit_error_prob_within_1e7_of_jax():
    """The port's own p (torch's float32 erfc) against the JAX
    package's on 200,000 Rayleigh fades at 5, 10 and 20 dB: not
    bit-identical, but within 1e-7 absolute — which is why the parity
    tests hand in the JAX package's p."""
    u = np.random.default_rng(0).uniform(1e-12, 1.0, 200_000) \
        .astype(np.float32)
    f2 = -np.log(u)
    for snr in (5.0, 10.0, 20.0):
        want = np.asarray(JCH.bpsk_bit_error_prob(snr, jnp.asarray(f2)))
        got = CH.bpsk_bit_error_prob(snr, torch.from_numpy(f2)).numpy()
        assert np.abs(got.astype(np.float64) - want).max() <= 1e-7
