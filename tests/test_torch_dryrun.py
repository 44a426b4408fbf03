"""The port's dry run and compile machinery (schemes/scaled.py's
`lower_step` / `warmup_compile`, launch/dryrun.py, launch/compile_cache.py)
on the CPU.

* The dry run's FLOPs equal the matmul FLOPs that the JAX package's dry
  run reads from the compiled HLO (launch/hlo_analysis.py's `dot_flops`)
  exactly: reduced qwen1.5-0.5b (remat off, batch 4 x seq 16) CL and
  SL, one prefill and one decode shape.
* `lower_step`'s argument bytes are the live scheme's state and batch
  bytes; the FL cycle puts its user axis on `pod`; the 16 x 16 mesh
  divides each leaf by the mesh axes its logical axes resolve to.
* `dryrun_one` writes JAX's keys, records an error and carries on.
* `warmup_compile` builds nothing on the CPU; `cache_dir()` honours
  `$REPRO_TORCH_KERNEL_CACHE_DIR`.
"""
import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import WirelessConfig as JW
from repro.launch.hlo_analysis import analyze
from repro.models import api as JM
from repro.nn import shapes_tree as j_shapes_tree
from repro.runtime import serve_step as JSS
from repro.runtime import train_step as JTS
from repro.schemes import build_scheme as j_build_scheme
from repro_torch.configs import ShapeConfig, WirelessConfig, get_arch
from repro_torch.kernels import build
from repro_torch.launch import compile_cache, dryrun
from repro_torch.launch.mesh import abstract_mesh, make_test_mesh
from repro_torch.nn import tree_leaves, use_mesh
from repro_torch.schemes import build_scheme

JCFG = dataclasses.replace(jax_arch("qwen1.5-0.5b").reduced(), remat=False)
CFG = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(), remat=False)
SHAPE = dict(name="t", seq_len=16, global_batch=4, kind="train",
             microbatch=4)
# the JAX package's dry-run counts (dot_flops of its compiled HLO)
DOT_FLOPS = {"cl": 610_271_232, "sl": 622_854_144}
# JAX's dry-run record keys
JAX_KEYS = {"arch", "shape", "mesh", "n_chips", "mode", "tag", "sync",
            "lower_s", "compile_s", "memory", "xla_cost_flops",
            "xla_bytes_accessed", "flops", "collectives", "collective_bytes",
            "hlo_lines", "ok"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dot_flops(lowered) -> int:
    return analyze(lowered.compile().as_text())["dot_flops"]


def _jax_trainable():
    return jax.eval_shape(lambda k: JTS.init_train_state(k, JCFG),
                          jax.ShapeDtypeStruct((2,), jnp.uint32)).trainable


@pytest.mark.parametrize("mode", ("cl", "sl"))
def test_dry_run_flops_equal_jax_dot_flops(mode):
    """`lower_step(make_test_mesh()).cost_analysis()` = the dot FLOPs of
    the JAX scheme's lowered round program, compiled."""
    jw, w = (JW(mode="sl", quant_bits=8), WirelessConfig(mode="sl",
                                                         quant_bits=8)) \
        if mode == "sl" else (None, None)
    js = j_build_scheme(jw, cfg=JCFG, shape=JShape(**SHAPE))
    ps = build_scheme(w, cfg=CFG, shape=ShapeConfig(**SHAPE), device="cpu")
    want = _dot_flops(js._lower_for_cost())
    assert want == DOT_FLOPS[mode]
    with use_mesh(make_test_mesh()):
        got = ps.lower_step(make_test_mesh()).cost_analysis()["flops"]
    assert got == want


@pytest.mark.parametrize("mode", ("cl", "sl"))
def test_step_flops_over_several_microbatches(mode):
    """At global batch 8 in microbatches of 2, the scheme's count (one
    microbatch's meta step times four) equals FlopCounterMode over the
    whole four-microbatch meta step, and the JAX scheme's dot FLOPs at
    that shape (trip-count-scaled over its microbatch scan), which are
    twice the batch-4 counts."""
    jw, w = (JW(mode="sl", quant_bits=8), WirelessConfig(mode="sl",
                                                         quant_bits=8)) \
        if mode == "sl" else (None, None)
    shape = dict(SHAPE, global_batch=8, microbatch=2)
    ps = build_scheme(w, cfg=CFG, shape=ShapeConfig(**shape), device="cpu")
    assert ps._micro_count(16) == 4
    whole = ps._count_flops(ps.shape.seq_len)       # all four microbatches
    assert ps._step_cost_flops() == whole == 2 * DOT_FLOPS[mode]
    js = j_build_scheme(jw, cfg=JCFG, shape=JShape(**shape))
    assert _dot_flops(js._lower_for_cost()) == whole


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_dry_run_flops_equal_jax_dot_flops_serving(kind):
    """The prefill step (the forward's last-token logits, batch 2 x 32)
    and one decode step against a 32-column cache (batch 2)."""
    jshape = JShape("s", 32, 2, kind)
    if kind == "prefill":
        step = JTS.make_prefill_step(JCFG, jshape)
        lowered = jax.jit(step).lower(_jax_trainable(),
                                      JM.input_specs(JCFG, jshape),
                                      JTS.key_sds())
    else:
        cache, _ = JSS.cache_specs(JCFG, jshape)
        lowered = jax.jit(JSS.make_decode_step(JCFG, jshape)).lower(
            j_shapes_tree(JM.param_specs(JCFG)), cache,
            jax.ShapeDtypeStruct((2, 1), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32))
    shape = ShapeConfig("s", 32, 2, kind)
    mesh = dryrun.CARD
    with use_mesh(mesh):
        port = (dryrun._lower_prefill(CFG, shape, mesh, "cl")
                if kind == "prefill" else
                dryrun._lower_decode(CFG, shape, mesh))
    assert port.cost_analysis()["flops"] == _dot_flops(lowered)


def test_lower_step_bytes_are_the_live_schemes():
    """SL (AdamW, codec) on the one-card mesh: argument bytes = the live
    scheme's state and one batch, exactly; the state is donated and
    comes back with the two metrics. The FL cycle on 2 x 16 x 16: every
    leaf's user axis on `pod` (2 users), so each device holds half."""
    ps = build_scheme(WirelessConfig(mode="sl", quant_bits=8), cfg=CFG,
                      shape=ShapeConfig(**SHAPE), device="cpu")
    st, _ = ps.init(0, *ps.default_data(8, 4, 0)[0])
    batch = ps.cycle_batches(st, np.random.default_rng(0), 0)[0]

    def nbytes(tree):
        leaves = tree_leaves(tree.trainable) + tree_leaves(
            tree.opt_state.mu) + tree_leaves(tree.opt_state.nu)
        return sum(t.numel() * t.element_size() for t in leaves)
    live = nbytes(st.train) + sum(t.numel() * t.element_size()
                                  for t in batch.values())
    mem = ps.lower_step(make_test_mesh()).memory_analysis()
    assert mem.argument_size_in_bytes == live
    assert mem.alias_size_in_bytes == nbytes(st.train)
    assert mem.output_size_in_bytes == nbytes(st.train) + 8
    assert mem.temp_size_in_bytes is None
    fl = build_scheme(WirelessConfig(mode="fl", n_users=2), cfg=CFG,
                      shape=ShapeConfig(**SHAPE), device="cpu")
    one = fl.lower_step(dryrun.CARD).memory_analysis()
    pod = fl.lower_step(abstract_mesh(multi_pod=True))
    assert pod.specs[0].trainable["model"]["ln_f"]["scale"][0] == "pod"
    assert pod.memory_analysis().argument_size_in_bytes * 2 \
        < one.argument_size_in_bytes
    pod16 = ps.lower_step(abstract_mesh())
    assert pod16.memory_analysis().argument_size_in_bytes \
        < mem.argument_size_in_bytes // 16


def test_dryrun_one_records_and_carries_on(tmp_path):
    """One record per combination with JAX's keys (the nulls explained);
    a combination that fails records its error and the run goes on."""
    recs = dryrun.main(["--arch", "qwen1.5-0.5b", "--reduced", "--shape",
                        "decode_32k", "--mesh", "card", "--out",
                        str(tmp_path)])
    assert [r["ok"] for r in recs] == [True]
    rec = json.loads((tmp_path / "qwen1.5-0.5b_decode_32k_card.json")
                     .read_text())
    assert JAX_KEYS <= set(rec) and rec["collectives"] is None
    assert set(rec["null_because"]) >= {"collectives", "compile_s"}
    assert rec["flops"] > 0 and rec["memory"]["argument_size_in_bytes"] > 0
    bad = dryrun.dryrun_one("paper-tinylstm", "train_4k", None,
                            out_dir=str(tmp_path))
    assert not bad["ok"] and "tiny" in bad["error"]
    assert (tmp_path / "paper-tinylstm_train_4k_card.json").exists()


def test_warmup_compile_builds_nothing_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "build_all", lambda *a: calls.append(a))
    monkeypatch.setattr(build, "load", lambda *a: calls.append(a))
    for w in (None, WirelessConfig(mode="sl"), WirelessConfig(mode="fl")):
        s = build_scheme(w, cfg=CFG, shape=ShapeConfig(**SHAPE),
                         device="cpu")
        assert 0.0 <= s.warmup_compile() < 1.0
        assert 0.0 <= compile_cache.warmup(s) < 1.0
    assert calls == []
    assert compile_cache.warmup(object()) == 0.0


def test_cache_dir_honours_its_variable(monkeypatch, tmp_path):
    """kernels/build.py's `build_dir()` is the one place the directory
    lives: $REPRO_TORCH_KERNEL_CACHE_DIR, else build/kernels/;
    `--no-compile-cache` sets the variable to a fresh directory."""
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == str(build.DEFAULT_BUILD_DIR.resolve())
    want = (tmp_path / "k").resolve()
    monkeypatch.setenv(compile_cache.ENV, str(want))
    assert compile_cache.cache_dir() == str(want)
    assert compile_cache.enable_persistent_cache() == str(want)
    assert want.is_dir()
    assert build.library_path("quant_channel").parent == want
    fresh = compile_cache.use_kernel_cache(no_cache=True)
    assert fresh != str(want) and os.path.isdir(fresh)
    assert os.environ[compile_cache.ENV] == fresh
    assert build.library_path("quant_channel").parent == build.build_dir()
    assert str(build.build_dir()) == str(Path(fresh).resolve())
