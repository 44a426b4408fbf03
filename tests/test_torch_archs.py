"""The five configurations this port registers beside qwen1.5-0.5b and
paper-tinylstm: field for field the JAX package's, with their published
widths and head dims; the three dense ones at `reduced()` (2 layers,
d_model 256, f32) against the live JAX transformer on the CPU — forward
and per-slot decode within 2e-4 (the JAX suite's attention tolerance):
chatglm3-6b's half-dim RoPE and QKV bias, command-r-plus-104b's
layernorm and parallel block, stablelm-12b's layernorm. And the head
dims the attention kernels are built for: stablelm-12b's 160 is not one
of them, and the launch raises naming the ROADMAP item, on any device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import api as JM
from repro.models import transformer as JT
from repro.nn import init_params as jax_init
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import build
from repro_torch.models import transformer as T
from repro_torch.nn import params_from_jax

TOL = 2e-4
NEW = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "chatglm3-6b",
       "command-r-plus-104b", "stablelm-12b")
DENSE = ("chatglm3-6b", "command-r-plus-104b", "stablelm-12b")
# (layers, d_model, heads, KV heads, head dim, vocab) as published
WIDTHS = {"qwen3-moe-235b-a22b": (94, 4096, 64, 4, 64, 151936),
          "llama4-scout-17b-a16e": (48, 5120, 40, 8, 128, 202048),
          "chatglm3-6b": (28, 4096, 32, 2, 128, 65024),
          "command-r-plus-104b": (64, 12288, 96, 8, 128, 256000),
          "stablelm-12b": (40, 5120, 32, 8, 160, 100352)}


@pytest.mark.parametrize("name", NEW)
def test_config_is_jaxs_field_for_field(name):
    cfg, jcfg = get_arch(name), jax_arch(name)
    assert name in list_archs()
    for f in dataclasses.fields(cfg):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.vocab_size) == WIDTHS[name]
    assert cfg.citation == jcfg.citation and cfg.citation
    red, jred = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(red):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(red, f.name) == getattr(jred, f.name), f.name
    assert red.hd == 64 and red.dtype == torch.float32


def test_served_head_dims_are_built_and_160_raises():
    """Every new config's head dim has an attention-kernel instance but
    stablelm-12b's: its launch raises naming ROADMAP.md's queue-2 item
    (checked before the device, so this holds without a card)."""
    built = {n for n in NEW if WIDTHS[n][4] in build.HEAD_DIMS}
    assert built == set(NEW) - {"stablelm-12b"}
    q = torch.zeros((1, 4, 160))
    k = torch.zeros((1, 1, 8, 160))
    with pytest.raises(ValueError, match=r"head dim 160 .*ROADMAP\.md, "
                       r"queue 2: \"K7-K10 at hd 160\""):
        build.attention_args("gqa_decode", q, k, k, 160)
    for hd in build.HEAD_DIMS:     # a built head dim gets to the device
        with pytest.raises(ValueError, match="must be on"):
            build.attention_args("gqa_decode", q[..., :hd], k[..., :hd],
                                 k[..., :hd], hd)


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    jcfg = jax_arch(request.param).reduced()
    cfg = get_arch(request.param).reduced()
    jp = jax_init(jax.random.PRNGKey(0), JM.param_specs(jcfg))
    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [l + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    jp = jax.tree.unflatten(tdef, [jnp.asarray(l) for l in leaves])
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_forward_matches_jax(model):
    jcfg, cfg, jp, params = model
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    ref, _ = JT.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg, 0)
    got, aux = T.forward(params, {"tokens": _t(tokens)}, cfg, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    assert float(aux["aux_loss"]) == 0.0


def test_decode_matches_jax_and_forward(model):
    """Per-slot decode at staggered depths with an inactive row against
    JAX's decode (logits and cache), and the last step's logits against
    the port's own teacher-forced forward."""
    jcfg, cfg, jp, params = model
    B, S = 3, 16
    rng = np.random.default_rng(2)
    jc, pc = JT.init_cache(jcfg, B, S), T.init_cache(cfg, B, S, "cpu")
    pos = np.array([0, 2, 5], np.int32)
    seqs = [[] for _ in range(B)]
    for step in range(6):
        tok = rng.integers(1, cfg.vocab_size, (B, 1), dtype=np.int32)
        active = np.array([True, step % 2 == 0, True])
        jl, jn = JT.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                                jcfg, 0)
        m = jnp.asarray(active)[None, :, None, None, None]
        jc = {k: jnp.where(m, jn[k], jc[k]) for k in jc}
        pl, _ = T.decode_step(params, pc, _t(tok), _t(pos), cfg, 0,
                              active=_t(active))
        np.testing.assert_allclose(pl.numpy()[active],
                                   np.asarray(jl)[active], rtol=TOL,
                                   atol=TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        for b in range(B):
            if active[b] and pos[b] == len(seqs[b]):
                seqs[b].append(int(tok[b, 0]))
        pos = pos + active
    # row 0 started at 0 and stayed active: its cache is its own prefix
    ref, _ = T.forward(params, {"tokens": _t(np.array([seqs[0]]))}, cfg)
    np.testing.assert_allclose(pl.numpy()[0, 0], ref.numpy()[0, -1],
                               rtol=TOL, atol=TOL)
