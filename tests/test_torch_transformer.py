"""Port parity: the reduced qwen1.5-0.5b transformer (2 layers, d 256,
f32) on the JAX package's own parameters — forward, per-slot decode and
fused chunk prefill, dense and paged, logits and caches within 2e-4 of
the JAX functions on the CPU; and within the port, paged == dense."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import api as JM
from repro.models import transformer as JT
from repro.nn import init_params as jax_init
from repro_torch.configs import get_arch
from repro_torch.models import api as M
from repro_torch.models import transformer as T
from repro_torch.nn import init_params, params_from_jax

TOL = 2e-4
JCFG = jax_arch("qwen1.5-0.5b").reduced()
CFG = get_arch("qwen1.5-0.5b").reduced()
PAGE = 8


@pytest.fixture(scope="module")
def both():
    jp = jax_init(jax.random.PRNGKey(0), JM.param_specs(JCFG))
    # make the zero-initialised biases and unit norm scales non-trivial
    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [l + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    jp = jax.tree.unflatten(tdef, [jnp.asarray(l) for l in leaves])
    np_tree = jax.tree.map(np.asarray, jp)
    return jp, np_tree, params_from_jax(np_tree, CFG, "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_matches_jax():
    import dataclasses
    for f in dataclasses.fields(CFG):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(CFG, f.name) == getattr(JCFG, f.name), f.name
    full = get_arch("qwen1.5-0.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab_size, full.qkv_bias) == \
        (24, 1024, 16, 16, 64, 2816, 151936, True)
    assert full.dtype == torch.bfloat16 and CFG.dtype == torch.float32


def test_params_from_jax_round_trip(both):
    _, np_tree, params = both
    for l in range(CFG.n_layers):
        lp = params["layers"][l]
        for path in (("attn", "wq", "w"), ("attn", "wq", "b"),
                     ("attn", "wo", "w"), ("mlp", "wg", "w"),
                     ("ln_mlp", "scale")):
            got, ref = lp, np_tree["layers"]
            for k in path:
                got, ref = got[k], ref[k]
            np.testing.assert_array_equal(got.numpy(), ref[l])
    np.testing.assert_array_equal(params["embed"]["table"].numpy(),
                                  np_tree["embed"]["table"])
    n_jax = sum(x.size for x in jax.tree.leaves(np_tree))
    assert sum(p.numel() for p in params.parameters()) == n_jax


def test_own_init_is_seeded_and_shaped():
    g = torch.Generator().manual_seed(3)
    a = init_params(M.param_specs(CFG), g, "cpu")
    b = init_params(M.param_specs(CFG), torch.Generator().manual_seed(3),
                    "cpu")
    assert torch.equal(a["layers"][1]["attn"]["wk"]["w"],
                       b["layers"][1]["attn"]["wk"]["w"])
    assert a["layers"][0]["attn"]["wq"]["w"].shape == (256, 256)
    assert torch.all(a["ln_f"]["scale"] == 1)


def test_forward_matches_jax(both):
    jp, _, params = both
    tokens = np.random.default_rng(1).integers(1, CFG.vocab_size, (2, 12),
                                               dtype=np.int32)
    ref, _ = JT.forward(jp, {"tokens": jnp.asarray(tokens)}, JCFG, 0)
    got, _ = T.forward(params, {"tokens": _t(tokens)}, CFG, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def _tables(B, n_lp):
    """Per-slot page tables over a pool with pages in reverse order."""
    return (np.arange(B * n_lp, dtype=np.int32)[::-1]
            .reshape(B, n_lp).copy())


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_decode_steps_match_jax(both, kv):
    """Per-slot decode at staggered depths with an inactive row:
    logits and the whole cache after every step."""
    jp, _, params = both
    B, S = 3, 16
    n_lp = S // PAGE
    rng = np.random.default_rng(2)
    if kv == "dense":
        jc, pc = JT.init_cache(JCFG, B, S), T.init_cache(CFG, B, S, "cpu")
    else:
        jc = JT.init_paged_cache(JCFG, B * n_lp, PAGE)
        pc = T.init_paged_cache(CFG, B * n_lp, PAGE, "cpu")
    tables = _tables(B, n_lp)
    pos = np.array([0, 3, 7], np.int32)
    for step in range(6):
        tok = rng.integers(1, CFG.vocab_size, (B, 1), dtype=np.int32)
        active = np.array([True, step % 2 == 0, True])
        if kv == "dense":
            jl, jn = JT.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), JCFG, 0)
            m = jnp.asarray(active)[None, :, None, None, None]
            jc = {k: jnp.where(m, jn[k], jc[k]) for k in jc}
            pl, _ = T.decode_step(params, pc, _t(tok), _t(pos), CFG, 0,
                                  active=_t(active))
        else:
            pages = {"tables": jnp.asarray(tables), "page_size": PAGE,
                     "active": jnp.asarray(active)}
            jl, jc = JT.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), JCFG, 0, pages=pages)
            pl, _ = T.decode_step(params, pc, _t(tok), _t(pos), CFG, 0,
                                  pages={"tables": _t(tables),
                                         "page_size": PAGE,
                                         "active": _t(active)})
        rows = active
        np.testing.assert_allclose(pl.numpy()[rows], np.asarray(jl)[rows],
                                   rtol=TOL, atol=TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        pos = pos + active


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_prefill_step_matches_jax(both, kv):
    """Fused chunk prefill: staggered starts, ragged n_valid (one row 0),
    last-valid logits and caches."""
    jp, _, params = both
    B, S, C = 4, 32, 8
    n_lp = S // PAGE
    tokens = np.random.default_rng(3).integers(1, CFG.vocab_size, (B, C),
                                               dtype=np.int32)
    start = np.array([0, 3, 9, 17], np.int32)
    n_valid = np.array([8, 1, 0, 5], np.int32)
    args_j = (jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(n_valid))
    args_p = (_t(tokens), _t(start), _t(n_valid))
    if kv == "dense":
        jl, jc = JT.prefill_step(jp, JT.init_cache(JCFG, B, S), *args_j,
                                 JCFG, 0)
        pl, pc = T.prefill_step(params, T.init_cache(CFG, B, S, "cpu"),
                                *args_p, CFG, 0)
    else:
        tables = _tables(B, n_lp)
        jl, jc = JT.prefill_step(
            jp, JT.init_paged_cache(JCFG, B * n_lp, PAGE), *args_j, JCFG, 0,
            pages={"tables": jnp.asarray(tables), "page_size": PAGE,
                   "active": None})
        pl, pc = T.prefill_step(
            params, T.init_paged_cache(CFG, B * n_lp, PAGE, "cpu"), *args_p,
            CFG, 0, pages={"tables": _t(tables), "page_size": PAGE,
                           "active": None})
    rows = n_valid > 0
    assert pl.dtype == torch.float32
    np.testing.assert_allclose(pl.numpy()[rows], np.asarray(jl)[rows],
                               rtol=TOL, atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_paged_equals_dense_within_port(both):
    """The same chunk then decode steps through the dense cache and
    through a shuffled page pool give identical logits."""
    _, _, params = both
    B, S, C = 2, 32, 8
    n_lp = S // PAGE
    rng = np.random.default_rng(4)
    tokens = _t(rng.integers(1, CFG.vocab_size, (B, C), dtype=np.int32))
    start = _t(np.zeros(B, np.int32))
    nv = _t(np.array([8, 6], np.int32))
    perm = np.random.default_rng(5).permutation(B * n_lp).astype(np.int32)
    pages = {"tables": _t(perm.reshape(B, n_lp)), "page_size": PAGE,
             "active": None}
    dc = T.init_cache(CFG, B, S, "cpu")
    pcache = T.init_paged_cache(CFG, B * n_lp, PAGE, "cpu")
    ld, _ = T.prefill_step(params, dc, tokens, start, nv, CFG)
    lp, _ = T.prefill_step(params, pcache, tokens, start, nv, CFG,
                           pages=pages)
    torch.testing.assert_close(lp, ld, rtol=0, atol=1e-6)
    pos = nv.clone()
    for _ in range(3):
        tok = _t(rng.integers(1, CFG.vocab_size, (B, 1), dtype=np.int32))
        ld, _ = T.decode_step(params, dc, tok, pos, CFG)
        lp, _ = T.decode_step(params, pcache, tok, pos, CFG,
                              pages=dict(pages, active=torch.ones(B, dtype=torch.bool)))
        torch.testing.assert_close(lp, ld, rtol=0, atol=1e-6)
        pos = pos + 1


def test_other_families_raise():
    """A family the JAX package does not have raises and names the
    port's families, every one of the JAX package's."""
    import dataclasses
    with pytest.raises(ValueError, match=r"the port has \['audio', "
                       r"'dense', 'hybrid', 'moe', 'ssm', 'tiny', 'vlm'\]"):
        M.get_model(dataclasses.replace(CFG, family="diffusion"))
