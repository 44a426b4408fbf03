"""The port at long_500k where the JAX package runs it without a window,
on the CPU against the live JAX package, at small widths:

* The plain paged attention at rows past the longest one a paged CTA
  once staged whole (kernels/csrc/kv_cols.cuh): the prefill at 13,312
  pages of 16 (212,992 columns; the refusal began at 12,672), the last
  chunk's 8 rows, and the decode at 32,768 pages (long_500k's row), at
  narrow heads (1 KV head, G 2, hd 16), without a window, through the
  port's wrappers against JAX's plain attention over the gathered pages
  (`prefill_attention_ref`, `decode_attention_jnp`) at the JAX suite's
  attention tolerance 2e-4 (tests/test_kernels.py:161).
* zamba2-1.2b at `reduced()` (two super-blocks of 1 Mamba2 block and the
  shared attention, d_model 256) through `make_prefill_step` (the scan,
  which the hybrid's missing fused prefill leaves) and `make_decode_step`
  at long_500k's shape with seq_len cut to 4,096: window 0 in both
  packages; a cache whose attention prefix [0, 3,968) and Mamba2 states
  are drawn from a seed, one prompt of 64 tokens at 3,968 and 64 greedy
  decode steps to a full cache. Tokens equal, logits within JAX's own
  decode tolerance 5e-3 (tests/test_archs_smoke.py:123). And its scan
  prefill of a chunk whose second row is padded past n_valid: the
  padded positions leave the states and K/V columns as JAX's mask does
  (logits and cache within 2e-4).
* xlstm-350m at `reduced()`: long_500k's cache holds as many bytes as
  seq_len 1's (the state is O(1)); a decode step at index 524,287 gives
  the bits of one at index 0 (the index is unused), in both packages,
  and the port's logits and states are JAX's within 2e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as jax_arch
from repro.kernels.prefill_attention.ref import \
    prefill_attention_ref as j_prefill_ref
from repro.models import api as JM
from repro.models import xlstm as JX
from repro.models.layers import decode_attention_jnp
from repro.nn import init_params as jax_init
from repro.runtime import serve_step as JSS
from repro.runtime import train_step as JTS
from repro_torch.configs import SHAPES, get_arch
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.prefill_attention import ops as pre
from repro_torch.models import api as M
from repro_torch.models import hybrid as H
from repro_torch.models import xlstm as X
from repro_torch.nn import params_from_jax
from repro_torch.runtime import serve_step as SS

ATTN_TOL, DEC_TOL, TOL = 2e-4, 5e-3, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- paged rows past the old limit
# (pages of 16, chunk rows or None for decode): the prefill's last chunk
# at the engine's 212,992-token prompt, the decode at long_500k's row
LONG_ROWS = {"prefill_13312_pages": (13_312, 8),
             "decode_32768_pages": (32_768, None)}
PAGE, HKV, G, HD = 16, 1, 2, 16


@pytest.mark.parametrize("case", sorted(LONG_ROWS))
def test_paged_attention_past_the_old_staging_limit_matches_jax(case):
    n_lp, C = LONG_ROWS[case]
    S = n_lp * PAGE
    rng = np.random.default_rng(n_lp)
    table = rng.permutation(n_lp).astype(np.int32)[None]
    kp, vp = (rng.standard_normal((n_lp, HKV, PAGE, HD)).astype(np.float32)
              for _ in "kv")
    q = rng.standard_normal((1, HKV * G, HD) if C is None
                            else (1, C, HKV * G, HD)).astype(np.float32)
    # the dense view the table names: column c of page table[c // PAGE]
    k, v = (x[table[0]].transpose(1, 0, 2, 3).reshape(1, HKV, S, HD)
            for x in (kp, vp))
    t = torch.from_numpy
    if C is None:
        length = np.array([S], np.int32)
        got = dec.gqa_decode_paged(t(q), t(kp), t(vp), t(table), t(length))
        want = decode_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(length))
    else:
        start = np.array([S - C], np.int32)
        got = pre.gqa_prefill_paged(t(q), t(kp), t(vp), t(table), t(start))
        # JAX's plain version in its kernel's layout [B, Hkv, C*G, hd]
        qk = q.reshape(1, C, HKV, G, HD).transpose(0, 2, 1, 3, 4) \
            .reshape(1, HKV, C * G, HD)
        want = j_prefill_ref(jnp.asarray(qk), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(start), g=G)
        want = np.asarray(want).reshape(1, HKV, C, G, HD) \
            .transpose(0, 2, 1, 3, 4).reshape(1, C, HKV * G, HD)
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_TOL)


# ----------------------------------------------------- zamba2's long_500k
HYBRID = "zamba2-1.2b"
L500_S, PROMPT, NEW = 4_096, 64, 64
# the Mamba2 states are drawn at 0.1 x a standard normal: a state the
# size of one a few hundred tokens of the random model leave, small
# enough that the drawn prefix does not swamp the prompt
STATE_SCALE = 0.1


def _long_shape(shapes):
    return dataclasses.replace(shapes["long_500k"], seq_len=L500_S)


def _drawn_cache(cfg, seed):
    """numpy leaves of a hybrid cache at L500_S: the attention slots'
    columns [0, L500_S - PROMPT - NEW) and the Mamba2 states from
    `seed`, the rest zero."""
    shapes = H.cache_shapes(cfg, 1, L500_S)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _, _) in shapes.items():
        x = np.zeros(shape, np.float32)
        if name in ("attn_k", "attn_v"):
            pre_len = L500_S - PROMPT - NEW
            x[..., :pre_len, :] = rng.standard_normal(
                shape[:3] + (pre_len, shape[4])).astype(np.float32)
        else:
            x[:] = STATE_SCALE * rng.standard_normal(shape)
        out[name] = x
    return out


def _hybrid_run(pkg, cfg, params, cache, prompt):
    """The scan prefill of `prompt` at L500_S - PROMPT - NEW, then NEW
    greedy decode steps, through `pkg`'s step builders at the cut
    long_500k. Returns (prompt logits, [decode logits], tokens)."""
    start = L500_S - PROMPT - NEW
    if pkg == "jax":
        S, arr, shape = JSS, jnp.asarray, _long_shape(J_SHAPES)
        prefill = S.make_prefill_step(cfg, shape, "scan")
    else:
        S, arr, shape = SS, torch.as_tensor, _long_shape(SHAPES)
        prefill = S.make_prefill_step(cfg, shape, "scan", "cpu")
    step = S.make_decode_step(cfg, shape)
    cache = {k: arr(np.array(x)) for k, x in cache.items()}
    ctx = jax.disable_jit() if pkg == "jax" else torch.no_grad()
    with ctx:
        lg, cache = prefill(params, cache, arr(prompt[None]),
                            arr(np.array([start], np.int32)),
                            arr(np.array([PROMPT], np.int32)))
        last = np.asarray(lg)[0]
        tok, outs, toks = int(last.argmax()), [], []
        for i in range(NEW):
            toks.append(tok)
            idx = arr(np.array([start + PROMPT + i], np.int32))
            out, cache = step(params, cache,
                              arr(np.array([[tok]], np.int32)), idx)
            outs.append(np.asarray(out)[0, 0])
            tok = int(outs[-1].argmax())
    return last, outs, toks


def test_zamba2_long_500k_construction_matches_jax():
    jcfg, cfg = jax_arch(HYBRID).reduced(), get_arch(HYBRID).reduced()
    assert JTS.window_for(jcfg, J_SHAPES["long_500k"]) == 0
    assert SS.window_for(cfg, SHAPES["long_500k"]) == 0
    assert SS.resolve_prefill_impl(M.get_model(cfg), "auto", "cuda") \
        == "scan"
    jp = jax_init(jax.random.PRNGKey(5), JM.param_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    cache = _drawn_cache(cfg, 30)
    prompt = np.random.default_rng(31).integers(
        1, cfg.vocab_size, PROMPT).astype(np.int32)
    j_last, j_outs, j_toks = _hybrid_run("jax", jcfg, jp, cache, prompt)
    p_last, p_outs, p_toks = _hybrid_run("torch", cfg, pp, cache, prompt)
    assert p_toks == j_toks
    np.testing.assert_allclose(p_last, j_last, rtol=0, atol=DEC_TOL)
    for i, (g, w) in enumerate(zip(p_outs, j_outs)):
        np.testing.assert_allclose(g, w, rtol=0, atol=DEC_TOL,
                                   err_msg=f"decode step {i}")
    assert all(np.isfinite(x).all() for x in [p_last] + p_outs)


def test_zamba2_scan_prefill_masks_the_padded_tail_as_jax():
    """Two rows of one chunk, the second padded past its n_valid: the
    port's scan prefill keeps the padded positions' states and K/V
    columns as JAX's masks them (logits and every cache leaf within
    2e-4), on a drawn cache of 64 columns."""
    jcfg, cfg = jax_arch(HYBRID).reduced(), get_arch(HYBRID).reduced()
    jp = jax_init(jax.random.PRNGKey(8), JM.param_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    shape = dataclasses.replace(SHAPES["long_500k"], seq_len=64,
                                global_batch=2)
    jshape = dataclasses.replace(J_SHAPES["long_500k"], seq_len=64,
                                 global_batch=2)
    rng = np.random.default_rng(32)
    cache = {name: (STATE_SCALE * rng.standard_normal(shp)).astype(
        np.float32) for name, (shp, _, _) in H.cache_shapes(cfg, 2,
                                                              64).items()}
    toks = rng.integers(1, cfg.vocab_size, (2, 8)).astype(np.int32)
    start, n_valid = np.array([40, 50], np.int32), np.array([8, 5],
                                                            np.int32)
    with jax.disable_jit():
        jl, jc = JSS.make_prefill_step(jcfg, jshape, "scan")(
            jp, {k: jnp.asarray(v) for k, v in cache.items()},
            jnp.asarray(toks), jnp.asarray(start), jnp.asarray(n_valid))
    with torch.no_grad():
        pl, pc = SS.make_prefill_step(cfg, shape, "scan", "cpu")(
            pp, {k: torch.from_numpy(v.copy()) for k, v in cache.items()},
            torch.from_numpy(toks), torch.from_numpy(start),
            torch.from_numpy(n_valid))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL)
    for k in cache:
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    # the padded tail wrote nothing: row 1's columns 55-57 are the drawn
    np.testing.assert_array_equal(pc["attn_k"][:, 1, :, 55:58].numpy(),
                                  cache["attn_k"][:, 1, :, 55:58])


# ------------------------------------------------------ xlstm's long_500k
XLSTM = "xlstm-350m"


def test_xlstm_long_500k_state_is_o1_and_the_index_unused():
    jcfg, cfg = jax_arch(XLSTM).reduced(), get_arch(XLSTM).reduced()
    seq = SHAPES["long_500k"].seq_len
    assert seq == J_SHAPES["long_500k"].seq_len == 524_288

    def nbytes(tree):
        return sum(np.asarray(x).nbytes for x in tree.values())
    long_j, one_j = JX.init_cache(jcfg, 1, seq), JX.init_cache(jcfg, 1, 1)
    long_p, one_p = X.init_cache(cfg, 1, seq, "cpu"), X.init_cache(cfg, 1, 1,
                                                                    "cpu")
    assert nbytes(long_j) == nbytes(one_j)
    assert sum(x.numel() * x.element_size() for x in long_p.values()) \
        == sum(x.numel() * x.element_size() for x in one_p.values()) \
        == nbytes(one_j)
    jp = jax_init(jax.random.PRNGKey(6), JM.param_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tok = np.array([[7]], np.int32)
    runs = {}
    for index in (0, seq - 1):
        jl, jc = JX.decode_step(jp, JX.init_cache(jcfg, 1, seq),
                                jnp.asarray(tok), jnp.int32(index), jcfg)
        with torch.no_grad():
            pl, pc = X.decode_step(pp, X.init_cache(cfg, 1, seq, "cpu"),
                                   torch.from_numpy(tok), index, cfg)
        runs[index] = (np.asarray(jl), {k: np.asarray(v)
                                        for k, v in jc.items()},
                       pl.numpy(), {k: v.numpy() for k, v in pc.items()})
    (j0, jc0, p0, pc0), (j1, jc1, p1, pc1) = runs[0], runs[seq - 1]
    np.testing.assert_array_equal(j1, j0)
    np.testing.assert_array_equal(p1, p0)
    for k in pc0:
        np.testing.assert_array_equal(pc1[k], pc0[k])
        np.testing.assert_array_equal(jc1[k], jc0[k])
        np.testing.assert_allclose(pc0[k], jc0[k], rtol=0, atol=TOL)
    np.testing.assert_allclose(p0, j0, rtol=0, atol=TOL)

