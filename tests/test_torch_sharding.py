"""The port's mesh builders and sharding rule engine
(``repro_torch.launch.{mesh,sharding}``) against the JAX package's:
counterparts of ``tests/test_sharding_and_data.py``'s rule tests; the
specs and ``ShardingReport`` of every parameter leaf of all ten configs,
smoke and full, and the batch, cache and optimizer specs, equal to the
reference's on duck-typed meshes (1, 1), (2, 4), (16, 16) and (2, 16, 16);
every device's local offset and shape under DTensor equal to JAX's
``NamedSharding.devices_indices_map`` on 8 forced host devices at (2, 4).
The reference's ``NamedSharding`` needs a real mesh, so on duck meshes it
is replaced by a record of its spec; JAX's 8 devices live in a
subprocess.
"""
import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import init_caches as jax_caches  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.train.step import init_train_state as jax_init_state  # noqa: E402,E501
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import init_caches, init_params  # noqa: E402
from repro_torch.train.step import Leaf, opt_layout  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


class Mesh:
    """A duck-typed mesh: axis names and sizes only."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"1x1": Mesh({"data": 1, "model": 1}),
          "2x4": Mesh({"data": 2, "model": 4}),
          "16x16": Mesh({"data": 16, "model": 16}),
          "2x16x16": Mesh({"pod": 2, "data": 16, "model": 16})}


@pytest.fixture
def spec_records(monkeypatch):
    """The reference's ``NamedSharding`` as a record of its spec."""
    monkeypatch.setattr(jsharding, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))


def ref_specs(tree) -> dict:
    """{path: spec as a tuple} of a reference sharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {jsharding._path_str(p): tuple(s.spec) for p, s in flat}


def port_specs(tree) -> dict:
    return {p: tuple(s.spec) for p, s in sharding._leaves(tree)}


def padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


# --- counterparts of tests/test_sharding_and_data.py ------------------------

def test_param_rules_cover_all_archs():
    mesh = MESHES["1x1"]
    from torch._subclasses.fake_tensor import FakeTensorMode
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b",
                 "falcon-mamba-7b", "recurrentgemma-2b", "musicgen-medium"):
        cfg = pconfigs.get_config(arch, smoke=True)
        with FakeTensorMode():
            model = init_params(cfg, 0, device="cpu")
        _, report = sharding.param_shardings(cfg, mesh, model)
        assert not report.fallback_replicated, (arch,
                                                report.fallback_replicated)


def test_expected_specs():
    mesh = MESHES["1x1"]
    rep = sharding.ShardingReport()
    assert sharding.spec_for("stack/attn/wq", 3, mesh, rep) == \
        (None, None, "model")
    assert sharding.spec_for("stack/attn/wo", 3, mesh, rep) == \
        (None, "model", None)
    assert sharding.spec_for("stack/ffn/w1", 4, mesh, rep) == \
        (None, "model", None, None)
    assert sharding.spec_for("embed", 2, mesh, rep) == ("model", None)
    assert sharding.spec_for("stack/ln1/w", 2, mesh, rep) == (None, None)


def test_nondivisible_dims_degrade_to_replicated():
    rep = sharding.ShardingReport()
    spec = sharding.spec_for("stack/attn/wq", 2, MESHES["2x4"], rep,
                             shape=(7, 13))
    assert spec == (None, None)
    assert rep.degraded_dims == [("stack/attn/wq", 1, "model", 13)]


def test_cache_shardings_pick_sequence_dim():
    mesh = MESHES["2x4"]
    tree = {"k": Leaf((4, 8, 64, 2, 16), torch.bfloat16)}
    spec = sharding.cache_shardings(mesh, tree, batch=8)["k"].spec
    assert spec == (None, "data", "model", None, None)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), mesh)


def test_dp_axes():
    from repro_torch.launch import mesh as mesh_mod
    assert mesh_mod.dp_axes(MESHES["2x16x16"]) == ("pod", "data")
    assert mesh_mod.dp_axes(MESHES["16x16"]) == ("data",)


# --- every leaf of all ten configs against the reference --------------------

_TREES: dict = {}


def trees(arch: str, smoke: bool):
    """(reference params, reference opt state, port model, port opt
    layout), shapes only, built once per config."""
    key = (arch, smoke)
    if key not in _TREES:
        from torch._subclasses.fake_tensor import FakeTensorMode
        jcfg = jconfigs.get_config(arch, smoke=smoke)
        params = jax.eval_shape(
            lambda: jax_init(jcfg, jax.random.PRNGKey(0)))
        train, _, opt = jax.eval_shape(
            lambda p: jax_init_state(jcfg, p), params)
        with FakeTensorMode():
            model = init_params(pconfigs.get_config(arch, smoke=smoke), 0,
                                device="cpu")
        _TREES[key] = (params, train, opt, model, opt_layout(model))
    return _TREES[key]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_param_and_opt_specs_equal_the_reference(spec_records, arch, smoke):
    params, train, opt, model, layout = trees(arch, smoke)
    for sp in (False, True):
        jcfg = jconfigs.get_config(arch, smoke=smoke, sp_attn=sp)
        pcfg = pconfigs.get_config(arch, smoke=smoke, sp_attn=sp)
        for name, mesh in MESHES.items():
            j_sh, j_rep = jsharding.param_shardings(jcfg, mesh, params)
            p_sh, p_rep = sharding.param_shardings(pcfg, mesh, model)
            want, got = ref_specs(j_sh), port_specs(p_sh)
            assert sorted(got) == sorted(want), (name, sp)
            for path, w in want.items():
                assert got[path] == w, (name, sp, path)
            assert (p_rep.matched, p_rep.fallback_replicated,
                    p_rep.degraded_dims) == (
                j_rep.matched, j_rep.fallback_replicated,
                [tuple(d) for d in j_rep.degraded_dims]), (name, sp)
            j_t, _ = jsharding.param_shardings(jcfg, mesh, train)
            j_opt = ref_specs(jsharding.opt_shardings(mesh, opt, j_t))
            p_opt = port_specs(sharding.opt_shardings(mesh, layout, p_sh))
            assert sorted(p_opt) == sorted(j_opt)
            for path, w in j_opt.items():
                assert padded(p_opt[path], len(w)) == padded(w, len(w)), \
                    (name, sp, path)


def _batch_trees(cfg, B, S):
    """The dry-run's inputs: the port's records and the reference's
    ``ShapeDtypeStruct``s of the same shapes."""
    from repro_torch.launch.dryrun import batch_struct, decode_token_struct
    out = []
    for port in (batch_struct(cfg, B, S), decode_token_struct(cfg, B)):
        ref = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
               for k, v in port.items()}
        out.append((port, ref))
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(spec_records, arch, smoke):
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, S = (8, 64) if smoke else (128, 32768)
    pcfg = pconfigs.get_config(arch, smoke=smoke)
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    j_caches = jax.eval_shape(lambda _: jax_caches(jcfg, B, S),
                              jnp.zeros(()))
    with FakeTensorMode():
        p_caches = init_caches(pcfg, B, S, "cpu")
    for name, mesh in MESHES.items():
        want = ref_specs(jsharding.cache_shardings(mesh, j_caches, B))
        got = port_specs(sharding.cache_shardings(mesh, p_caches, B))
        assert sorted(got) == sorted(want), name
        for path, w in want.items():
            assert padded(got[path], len(w)) == padded(w, len(w)), \
                (name, path)
        for port, ref in _batch_trees(pcfg, B, S):
            want = ref_specs(jsharding.batch_shardings(mesh, ref, B))
            got = port_specs(sharding.batch_shardings(mesh, port, B))
            assert got == {k: padded(w, len(got[k])) for k, w in
                           want.items()}, name


# --- local shards against JAX's devices_indices_map -------------------------

_JAX_INDICES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.stdin.read())
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = []
for shape, spec in cases:
    spec = [tuple(a) if isinstance(a, list) else a for a in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out.append([[[s.indices(n)[:2] for s, n in zip(idx[d], shape)]
                 for d in row] for row in mesh.devices])
print(json.dumps(out))
"""


def _offset_cases():
    """(shape, spec) of qwen3-4b smoke's parameters (pim_w4, stacked
    shapes), its batch, its decode caches, and tuple axes, at (2, 4)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = MESHES["2x4"]
    cfg = pconfigs.get_config("qwen3-4b", smoke=True, quant="pim_w4")
    with FakeTensorMode():
        model = init_params(cfg, 0, device="cpu")
        caches = init_caches(cfg, 8, 64, "cpu")
    from repro_torch.models import param_tree
    cases = []
    p_sh, _ = sharding.param_shardings(cfg, mesh, model)
    for path, leaf in sharding._leaves(param_tree(model)):
        cases.append((sharding.leaf_shape(leaf), p_sh_spec(p_sh, path)))
    for path, sh in sharding._leaves(
            sharding.cache_shardings(mesh, caches, 8)):
        leaf = dict(sharding._leaves(caches))[path]
        cases.append((tuple(leaf.shape), sh.spec))
    cases.append(((8, 64), (("data",), None)))
    cases.append(((16, 6), (("data", "model"), None)))
    cases.append(((4, 24), (None, ("data", "model"))))
    return cases


def p_sh_spec(tree, path):
    return dict(sharding._leaves(tree))[path].spec


def test_local_shards_equal_jax_devices_indices_map():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.launch.dryrun import fake_world
    cases = _offset_cases()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_INDICES], input=json.dumps(
            [[list(s), [list(a) if isinstance(a, tuple) else a for a in sp]]
             for s, sp in cases]),
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout)
    for rank in range(8):
        i, j = divmod(rank, 4)
        with fake_world(8, rank):
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            assert tuple(mesh.get_coordinate()) == (i, j)
            for (shape, spec), w in zip(cases, want):
                local, offset = compute_local_shape_and_global_offset(
                    shape, mesh, sharding.placements(spec, mesh))
                got = [[o, o + n] for o, n in zip(offset, local)]
                assert got == [list(x) for x in w[i][j]], (shape, spec, rank)
