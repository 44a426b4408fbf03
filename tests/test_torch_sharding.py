"""Port parity for the mesh machinery (nn/sharding.py, launch/mesh.py,
the sharding helpers of runtime/train_step.py and models/api.py) against
the JAX package on the CPU.

* `resolve_spec` gives JAX's spec for every leaf of every registered
  config's parameters, train state (AdamW; SGD with and without the FL
  "users" axis) and inputs, at mesh shapes 16 x 16, 2 x 16 x 16, 2 x 2,
  1 x 1 and 1 x 1 x 1 (JAX's resolver reads only `mesh.shape`, so it is
  handed a stub), and the two packages list the same leaves with the
  same logical axes and shapes.
* The resolver tests of tests/test_sharding.py, on a one-card mesh and
  on an abstract 2 x 2 one.
* `constrain` is the identity on one device and raises where it would
  split a tensor.
* `launch.train --mesh test` equals `--mesh none` bit for bit (bills,
  losses, accuracies) for reduced CL / SL / FL and a 4-client fleet.
* The MoE layer under a mesh at >= 2,048 tokens (JAX's expert-parallel
  `_moe_ep`, here on its own `Auto`-axes 1 x 1 mesh: `make_test_mesh`'s
  `Explicit` axes refuse `with_sharding_constraint`) against the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jax_arch
from repro.configs import list_archs as jax_list_archs
from repro.configs.base import WirelessConfig as JW
from repro.models import api as JM
from repro.models import moe as JMOE
from repro.nn import init_params as jax_init
from repro.nn import shapes_tree as j_shapes_tree
from repro.nn import sharding as JSH
from repro.runtime import train_step as JTS
from repro_torch.configs import SHAPES, WirelessConfig, get_arch, list_archs
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train
from repro_torch.models import api as M
from repro_torch.models import moe as MOE
from repro_torch.nn import (constrain, constrain_tree, params_from_jax,
                            resolve_spec, shapes_tree, tree_shardings,
                            use_mesh)
from repro_torch.nn.sharding import map_axes
from repro_torch.runtime import train_step as TS

MESH_SHAPES = (((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((2, 2), ("data", "model")),
               ((1, 1), ("data", "model")),
               ((1, 1, 1), ("pod", "data", "model")))


class _StubMesh:
    """All that JAX's `resolve_spec` reads of a mesh."""

    def __init__(self, sizes, axes):
        self.shape = dict(zip(axes, sizes))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: a multi-threaded CPU run is not reproducible
    run to run, and the --mesh comparisons are bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ parity
def _jax_leaves(axes_tree, shapes):
    """[(axes, shape)] of a JAX (axes tree, ShapeDtypeStruct tree), in
    the order `jax.tree.map` with an axes-leaf predicate visits them."""
    out = []
    jax.tree.map(lambda ax, s: out.append((ax, tuple(s.shape))), axes_tree,
                 shapes, is_leaf=JTS._is_axes_leaf)
    return out


def _port_leaves(axes_tree, shapes):
    out = []
    map_axes(lambda ax, t: out.append((ax, tuple(getattr(t, "shape", ())))),
             axes_tree, shapes)
    return out


def _jax_state(jcfg, jw, opt, n_users):
    sds = jax.eval_shape(
        lambda k: JTS.init_train_state(k, jcfg, jw, opt),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    if n_users:
        sds = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            (n_users,) + s.shape, s.dtype), sds)
        # the port's step counters are ints: no user axis to stack
        sds = sds._replace(step=jax.ShapeDtypeStruct((), jnp.int32),
                           opt_state=sds.opt_state._replace(
                               step=jax.ShapeDtypeStruct((), jnp.int32)))
    return _jax_leaves(JTS.train_state_axes(jcfg, jw, opt, n_users), sds)


def test_registries_agree():
    assert sorted(list_archs()) == sorted(jax_list_archs())
    assert SHAPES == {k: type(SHAPES[k])(**dataclasses.asdict(v))
                      for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_resolve_spec_matches_jax_on_every_leaf(arch):
    """Parameters, AdamW / SGD state (SL codec included), the user-
    stacked FL state and the train and decode inputs: the same leaves,
    axes and shapes, and JAX's spec for each at every mesh shape."""
    jcfg, cfg = jax_arch(arch), get_arch(arch)
    trees = {"params": (
        _jax_leaves(JM.param_axes(jcfg), j_shapes_tree(JM.param_specs(jcfg))),
        _port_leaves(M.param_axes(cfg),
                     shapes_tree(M.train_param_specs(cfg))))}
    for opt, sl, users in (("adamw", False, 0), ("adamw", True, 0),
                           ("sgd", False, 0), ("sgd", False, 3)):
        jw, w = (JW(mode="sl"), WirelessConfig(mode="sl")) if sl \
            else (None, None)
        trees[f"state {opt} sl={sl} users={users}"] = (
            _jax_state(jcfg, jw, opt, users),
            _port_leaves(TS.train_state_axes(cfg, w, opt, users),
                         TS.train_state_sds(cfg, w, opt, users)))
    for name in ("train_4k", "decode_32k"):
        trees[f"inputs {name}"] = (
            _jax_leaves(JM.input_axes(jcfg, JSHAPES[name]),
                        JM.input_specs(jcfg, JSHAPES[name])),
            _port_leaves(M.input_axes(cfg, SHAPES[name]),
                         M.input_sds(cfg, SHAPES[name])))
    # the tree helpers give the same specs, leaf for leaf
    mesh = MESH.abstract_mesh(multi_pod=True)
    helpers = {"params": tree_shardings(shapes_tree(M.train_param_specs(
        cfg)), M.param_axes(cfg), mesh),
        "state adamw sl=False users=0": tree_shardings(
            TS.train_state_sds(cfg), TS.train_state_axes(cfg), mesh)}
    for what, specs in helpers.items():
        axes = M.param_axes(cfg) if what == "params" else \
            TS.train_state_axes(cfg)
        got = []
        map_axes(lambda ax, spec: got.append(spec), axes, specs)
        assert got == [resolve_spec(shape, ax, mesh)
                       for ax, shape in trees[what][1]], what
    n = 0
    for what, (want, got) in trees.items():
        assert got == want, what
        for sizes, axes in MESH_SHAPES:
            stub, mesh = _StubMesh(sizes, axes), MESH.Mesh(axes, sizes)
            for ax, shape in want:
                assert resolve_spec(shape, ax, mesh) == tuple(
                    JSH.resolve_spec(shape, ax, stub)), (what, sizes, ax)
                n += 1
    assert n > 0


# ----------------------------------------- tests/test_sharding.py's
def _meshes():
    return (MESH.make_test_mesh((1, 1), ("data", "model")),
            MESH.Mesh(("data", "model"), (2, 2)))


@pytest.mark.parametrize("mesh", _meshes(), ids=("card", "abstract_2x2"))
@pytest.mark.parametrize("case", ("basic", "divisibility", "no_axis_reuse",
                                  "unknown_axis", "users_to_pod"))
def test_resolver(case, mesh):
    """tests/test_sharding.py's resolver tests: "batch" to data and
    "mlp" to model (size-1 axes still match); an axis only where its
    size divides the dim; no mesh axis on two dims; an unknown logical
    axis replicates; "users" onto pod, batch degrading to data."""
    if case == "basic":
        assert resolve_spec((64, 128), ("batch", "mlp"), mesh) == \
            ("data", "model")
    elif case == "divisibility":
        for d0 in (1, 2, 3, 4, 6, 64):
            for d1 in (1, 2, 5, 16, 128):
                spec = resolve_spec((d0, d1), ("batch", "mlp"), mesh)
                parts = spec + (None,) * (2 - len(spec))
                for dim, part in zip((d0, d1), parts):
                    if part is not None:
                        axes = (part,) if isinstance(part, str) else part
                        size = int(np.prod([mesh.shape[a] for a in axes]))
                        assert dim % size == 0
    elif case == "no_axis_reuse":
        spec = resolve_spec((64, 64, 64), ("batch", "embed", "mlp"), mesh)
        used = [a for p in spec if p is not None
                for a in ((p,) if isinstance(p, str) else p)]
        assert len(used) == len(set(used))
    elif case == "unknown_axis":
        assert resolve_spec((64,), ("no_such_rule",), mesh) == ()
    else:
        pod = MESH.Mesh(("pod",) + mesh.axis_names, (mesh.sizes[0],)
                        + mesh.sizes)
        assert resolve_spec((2, 8, 16), ("users", "batch", None), pod) == \
            ("pod", "data")


# ------------------------------------------------------------- meshes
def test_meshes_on_one_card():
    """The test mesh degrades to all ones over the one device; the
    abstract descriptor has the production shape and no device."""
    m = MESH.make_test_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert m.device.type in ("cpu", "cuda")
    a = MESH.abstract_mesh(multi_pod=True)
    assert a.shape == {"pod": 2, "data": 16, "model": 16} and a.abstract
    with pytest.raises(RuntimeError, match="abstract"):
        a.device
    with pytest.raises(RuntimeError, match="spans 4 cards"):
        MESH.Mesh(("data", "model"), (2, 2), (m.device,) * 4).device


def test_constrain_identity_on_one_device_raises_when_it_would_split():
    x = torch.ones(8, 8)
    assert constrain(x, "batch", "mlp") is x
    with use_mesh(MESH.make_test_mesh()):
        assert constrain(x, "batch", "mlp") is x
        tree = {"a": x, "b": [x]}
        assert constrain_tree(tree, {"a": ("batch", None),
                                     "b": [("mlp", None)]}) == tree
    with use_mesh(MESH.abstract_mesh()):
        y = torch.ones(3, 5)           # nothing divides: replicated
        assert constrain(y, "batch", "mlp") is y
        with pytest.raises(RuntimeError, match="one card"):
            constrain(torch.ones(32, 8), "batch", "mlp")


def test_dist_decode_and_expert_parallel_raise_on_a_split_model_axis():
    """Where JAX would shard the decode cache or the experts over a
    model axis of more than one device, the port raises; on the
    one-card mesh both run."""
    from repro_torch.models import layers as L
    cfg = get_arch("qwen3-moe-235b-a22b").reduced()
    mesh = MESH.Mesh(("data", "model"), (1, 2))
    x = torch.zeros((1, 2048, cfg.d_model))
    with use_mesh(mesh), pytest.raises(RuntimeError, match="one card"):
        MOE.apply_moe({}, x, cfg)
    q = torch.zeros((1, 1, cfg.d_model))
    p = {k: {n: torch.zeros(t.shape) for n, t in v.items()}
         for k, v in shapes_tree(L.attention_specs(cfg)).items()}
    cache = torch.zeros((1, cfg.n_kv_heads, 8, cfg.hd))
    with use_mesh(mesh), pytest.raises(RuntimeError, match="one card"):
        L.attention_decode_slots(p, q, cfg, cache, cache.clone(),
                                 torch.zeros(1, dtype=torch.int32))
    with use_mesh(MESH.make_test_mesh()):
        out, _, _ = L.attention_decode_slots(
            p, q, cfg, cache, cache.clone(), torch.zeros(1, dtype=torch.int32))
    assert out.shape == q.shape


# ------------------------------------------------------- mesh = none
def _train(argv):
    out = train.main(argv)
    exp = out["experiment"]
    return ([(r.bits, r.n_tx, r.energy_j, r.erased_bits, r.loss)
             for r in exp.reports],
            out["result"].accuracy, out["result"].loss)


@pytest.mark.parametrize("argv", (
    ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "cl", "--steps", "2",
     "--cycle-steps", "1", "--batch", "2", "--seq", "16", "--n-train", "32",
     "--n-test", "4"],
    ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "sl", "--steps", "2",
     "--cycle-steps", "1", "--batch", "2", "--seq", "16", "--n-train", "32",
     "--n-test", "4", "--snr-db", "5"],
    ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "fl", "--steps", "1",
     "--local-steps", "1", "--n-users", "2", "--batch", "2", "--seq", "16",
     "--n-train", "32", "--n-test", "4", "--snr-db", "5"],
    ["--arch", "paper-tinylstm", "--fleet-size", "4", "--fleet-engine",
     "loop", "--fleet-sl-frac", "0.5", "--fleet-sample", "0", "--steps",
     "1", "--n-train", "2048", "--n-test", "256"],
), ids=("cl", "sl", "fl", "fleet4"))
def test_mesh_test_equals_mesh_none(argv):
    base = argv + ["--device", "cpu", "--log-every", "100"]
    assert _train(base + ["--mesh", "test", "--aot-warmup"]) == \
        _train(base + ["--mesh", "none"])


# ------------------------------------------------------------------ MoE
def test_moe_under_a_mesh_matches_jax_expert_parallel():
    """At 2,048 tokens under a mesh with a `model` axis, where JAX takes
    its expert-parallel branch (at one shard the chunked dispatch), the
    port's layer against live JAX's `_moe_ep` on its own `Auto`-axes 1 x 1
    mesh (chunks of 512 tokens, capacity per chunk) at 2e-4. JAX's
    `_moe_ep` is called outside JAX's `use_mesh`: under it, `constrain`
    inside the `shard_map` body names the manual `model` axis, which
    this JAX refuses. JAX's `_moe_ep` equals its own `_moe_chunked` bit
    for bit here, which is why the port has only `_moe_chunked`."""
    jcfg = dataclasses.replace(jax_arch("qwen3-moe-235b-a22b").reduced(),
                               moe_chunk=512)
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").reduced(),
                              moe_chunk=512)
    jp = jax_init(jax.random.PRNGKey(5), JMOE.moe_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), None, "cpu")
    x = np.random.default_rng(6).standard_normal(
        (2, MOE.EP_MIN_TOKENS // 2, jcfg.d_model)).astype(np.float32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    jy, jaux = JMOE._moe_ep(jp, jnp.asarray(x), jcfg, jmesh)
    cy, caux = JMOE._moe_chunked(jp, jnp.asarray(x), jcfg)
    assert np.array_equal(np.asarray(jy), np.asarray(cy))
    with use_mesh(MESH.make_test_mesh()):
        y, aux = MOE.apply_moe(pp, torch.from_numpy(x), cfg)
    y_none, _ = MOE.apply_moe(pp, torch.from_numpy(x), cfg)
    assert torch.equal(y, y_none)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    for k in ("lb_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
        assert float(jaux[k]) == float(caux[k]), k
