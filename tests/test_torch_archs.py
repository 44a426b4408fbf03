"""The seven configurations this port registers beside qwen1.5-0.5b and
paper-tinylstm: field for field the JAX package's, with their published
widths and head dims; the three dense ones at `reduced()` (2 layers,
d_model 256, f32) against the live JAX transformer on the CPU — forward
and per-slot decode within 2e-4 (the JAX suite's attention tolerance):
chatglm3-6b's half-dim RoPE and QKV bias, command-r-plus-104b's
layernorm and parallel block, stablelm-12b's layernorm. And the head
dims the attention kernels are built for: every attention config's,
stablelm-12b's 160 among them; an unbuilt head dim raises naming the
missing instance, on any device. At hd 160 the plain versions the
wrappers run on CPU tensors are held to the JAX package's Pallas
kernels in interpret mode (G 4, dense and paged, decode and prefill)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import attn_fixture, paged_from_dense
from repro.configs import get_arch as jax_arch
from repro.kernels.decode_attention import ops as jax_decode
from repro.kernels.prefill_attention import ops as jax_prefill
from repro.models import api as JM
from repro.models import transformer as JT
from repro.nn import init_params as jax_init
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as pt_decode
from repro_torch.kernels.prefill_attention import ops as pt_prefill
from repro_torch.models import transformer as T
from repro_torch.nn import params_from_jax

TOL = 2e-4
NEW = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "chatglm3-6b",
       "command-r-plus-104b", "stablelm-12b")
DENSE = ("chatglm3-6b", "command-r-plus-104b", "stablelm-12b")
# the attention configs (K7-K10 serve them) and xLSTM, whose recurrent
# heads reach no attention kernel
ATTENTION = NEW + ("internvl2-76b",)
CONFIGS = ATTENTION + ("xlstm-350m",)
# (layers, d_model, heads, KV heads, head dim, vocab) as published
WIDTHS = {"internvl2-76b": (80, 8192, 64, 8, 128, 128256),
          "xlstm-350m": (24, 1024, 4, 4, 256, 50304),
          "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 64, 151936),
          "llama4-scout-17b-a16e": (48, 5120, 40, 8, 128, 202048),
          "chatglm3-6b": (28, 4096, 32, 2, 128, 65024),
          "command-r-plus-104b": (64, 12288, 96, 8, 128, 256000),
          "stablelm-12b": (40, 5120, 32, 8, 160, 100352)}


@pytest.mark.parametrize("name", CONFIGS)
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
    """Every attention config's head dim has an attention-kernel
    instance, stablelm-12b's 160 too; an unbuilt head dim (96) raises
    naming the missing instance (checked before the device, so this
    holds without a card). The test keeps its name from when 160 was
    the head dim that raised."""
    assert set(build.HEAD_DIMS) == {64, 128, 160}
    assert {n for n in ATTENTION if WIDTHS[n][4] in build.HEAD_DIMS} == \
        set(ATTENTION)
    q = torch.zeros((1, 4, 96))
    k = torch.zeros((1, 1, 8, 96))
    with pytest.raises(ValueError, match=r"head dim 96 not in \(64, 128, "
                       r"160\).*no instance.*dispatch_hd"):
        build.attention_args("gqa_decode", q, k, k, 96)
    q, k = torch.zeros((1, 4, 160)), torch.zeros((1, 1, 8, 160))
    for hd in build.HEAD_DIMS:     # a built head dim gets to the device
        with pytest.raises(ValueError, match="must be on"):
            build.attention_args("gqa_decode", q[..., :hd], k[..., :hd],
                                 k[..., :hd], hd)


# stablelm-12b's heads: 8 KV heads of hd 160 at G 4 (here 2 KV heads)
HD160 = dict(hkv=2, g=4, hd=160)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("paged", [False, True])
def test_hd160_decode_plain_matches_jax_kernel(paged, window):
    """K7 / K8's plain versions at hd 160 against the Pallas decode
    kernels in interpret mode (which pad hd to a lane multiple)."""
    q, k, v = attn_fixture(11, 4, HD160["hkv"], HD160["g"], 64,
                           HD160["hd"])
    length = np.array([1, 17, 40, 64], np.int32)
    if paged:
        kp, vp, tables, spare = paged_from_dense(k, v, 16, 12)
        for bi, ln in enumerate(length):
            tables[bi, -(-ln // 16):] = spare
        ref = jax_decode.gqa_decode_paged(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(length), window=window,
            interpret=True)
        got = pt_decode.gqa_decode_paged(_t(q), _t(kp), _t(vp), _t(tables),
                                         _t(length), window=window)
    else:
        ref = jax_decode.gqa_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(length),
                                    window=window, interpret=True)
        got = pt_decode.gqa_decode(_t(q), _t(k), _t(v), _t(length),
                                   window=window)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("paged", [False, True])
def test_hd160_prefill_plain_matches_jax_kernel(paged, window):
    """K9 / K10's plain versions at hd 160 against the Pallas prefill
    kernels in interpret mode, chunks of 16 at staggered starts."""
    c = 16
    q, k, v = attn_fixture(13, 4, HD160["hkv"], HD160["g"], 64,
                           HD160["hd"], c=c)
    start = np.array([0, 5, 23, 64 - c], np.int32)
    if paged:
        kp, vp, tables, spare = paged_from_dense(k, v, 16, 14)
        for bi, st in enumerate(start):
            tables[bi, -(-(st + c) // 16):] = spare
        ref = jax_prefill.gqa_prefill_paged(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(start), window=window,
            interpret=True)
        got = pt_prefill.gqa_prefill_paged(_t(q), _t(kp), _t(vp),
                                           _t(tables), _t(start),
                                           window=window)
    else:
        ref = jax_prefill.gqa_prefill(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(start),
                                      window=window, interpret=True)
        got = pt_prefill.gqa_prefill(_t(q), _t(k), _t(v), _t(start),
                                     window=window)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=TOL, atol=TOL)


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
