"""The port's collectives and elastic restore on 4 ``gloo`` ranks, against
the JAX package: ``optim.grad_compress.psum_compressed`` against the
reference's under ``shard_map`` on 4 forced host devices, bit for bit,
with and without a residual; a sharded ``ckpt.checkpoint.restore`` onto a
(2, 2) mesh, from a checkpoint written by the port and from one written by
the reference, every array gathered bit for bit; and the sharded model
path on values: each of the ten configs' float32 smoke models on a (2, 2)
mesh of 4 ranks (parameters, optimizer state, batch and caches placed by
the rule engine) against the same model in one process, the port's plain
path that the other tests hold to the JAX package: the loss, a prefill
and one decode step (logits and caches, from prefill's caches and from
the same caches placed by ``cache_shardings``), and one training step from
a resumed optimizer state (its metrics, the updated parameters and the
ZeRO-1 moments, gathered). The ranks and the reference's devices each run
in processes of their own.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.train.step import init_train_state as jax_init_state  # noqa: E402,E501
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.ckpt.checkpoint import train_state  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402

from torch_once import once  # noqa: E402
import torch_mesh_drive  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
RANKS = 4
SHAPE = (64, 48)
ARCH = {"arch_id": "qwen3-4b", "smoke": True, "quant": "pim_w4"}

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.grad_compress import psum_compressed
d = sys.argv[1]
z = np.load(os.path.join(d, "inputs.npz"))
mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
out = {}
for case in ("none", "residual"):
    def f(g, r):
        t, res = psum_compressed(g[0], "x",
                                 r[0] if case == "residual" else None)
        return t[None], res[None]
    t, res = jax.shard_map(f, mesh=mesh, in_specs=(P("x"), P("x")),
                           out_specs=(P("x"), P("x")))(
        jnp.asarray(z["g"]), jnp.asarray(z["r"]))
    out[case + "_total"] = np.asarray(t)
    out[case + "_residual"] = np.asarray(res)
np.savez(os.path.join(d, "reference.npz"), **out)
"""

_RANK = r"""
import os, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
d, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
from repro_torch import configs
from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import train_state
from repro_torch.launch import sharding
from repro_torch.models import init_params
from repro_torch.optim.grad_compress import psum_compressed
from repro_torch.train.step import opt_layout, trainable_params

z = np.load(os.path.join(d, "inputs.npz"))
out = {}
g, r = torch.from_numpy(z["g"][rank]), torch.from_numpy(z["r"][rank])
for case in ("none", "residual"):
    t, res = psum_compressed(g, None, r if case == "residual" else None)
    out[case + "_total"], out[case + "_residual"] = t.numpy(), res.numpy()

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = configs.get_config("qwen3-4b", smoke=True, quant="pim_w4")
for which in ("port", "reference"):
    model = init_params(cfg, 5, device="cpu")
    p_shard, _ = sharding.param_shardings(cfg, mesh, model)
    sharding.distribute_model(model, mesh, p_shard)
    layout = opt_layout(model)
    o_shard = sharding.opt_shardings(mesh, layout, p_shard)
    ps = trainable_params(model)
    skeleton = train_state(model, {"mu": ps, "nu": ps, "step": 0})
    zero = lambda tree: {k: zero(v) if isinstance(v, dict) else 0
                         for k, v in tree.items()}
    skeleton["opt"] = {"mu": zero(layout["mu"]), "nu": zero(layout["nu"]),
                       "step": 0}
    tree, _ = checkpoint.restore(os.path.join(d, which), 7, skeleton,
                                 shardings={"opt": o_shard})
    for k, v in checkpoint._flatten(tree).items():
        if isinstance(v, checkpoint.Stacked):
            locs = [t.to_local() for t in v.tensors]
            full = torch.stack([t.full_tensor() for t in v.tensors])
        elif hasattr(v, "full_tensor"):
            locs, full = [v.to_local()], v.full_tensor()
        else:
            locs, full = [v], v
        out[f"{which}/shape/{k}"] = np.array([list(t.shape) for t in locs])
        if rank == 0:
            if full.dtype == torch.bfloat16:
                full = full.view(torch.int16)
            out[f"{which}/full/{k}"] = full.detach().numpy()
np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
dist.destroy_process_group()
"""


_MESH_RANK = r"""
import os, sys
import numpy as np, torch.distributed as dist
d, rank, port, tests = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
sys.path.insert(0, tests)
from torch_mesh_drive import drive, moe_layer
from repro_torch import configs
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
with implicit_replication():
    for arch in configs.ARCH_IDS:
        out = drive(arch, mesh)
        if configs.get_config(arch).moe is not None:
            out.update({"moe_layer/" + k: v
                        for k, v in moe_layer(arch, mesh).items()})
        if rank == 0:
            np.savez(os.path.join(d, arch + ".npz"), **out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **extra)


def _reference_state(seed):
    jcfg = jconfigs.get_config(**ARCH)
    params = jax_init(jcfg, jax.random.PRNGKey(seed))
    train, _, opt = jax_init_state(jcfg, params, False)
    rng = np.random.default_rng(seed)
    rand = lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32)  # noqa: E731,E501
    opt = {k: (jnp.asarray(7, jnp.int32) if k == "step"
               else jax.tree.map(rand, v)) for k, v in opt.items()}
    return {"train": train, "opt": opt}


def _port_state(seed):
    model = init_params(pconfigs.get_config(**ARCH), seed, device="cpu")
    opt = init_train_state(model)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key in ("mu", "nu"):
            for t in opt[key]:
                t.copy_(torch.randn(t.shape, generator=gen))
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    return train_state(model, opt)


def _bits(v) -> np.ndarray:
    if isinstance(v, checkpoint.Stacked):
        v = torch.stack([t.detach() for t in v.tensors])
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.view(torch.int16) if v.dtype == torch.bfloat16
                else v).numpy()
    a = np.asarray(v)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _build(d: str) -> None:
    """Inputs and both checkpoints written here, then the reference's
    process and the four ranks, all started together."""
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((RANKS,) + SHAPE) * np.array(
        [1.0, 3.0, 0.5, 2.0])[:, None, None]).astype(np.float32)
    r = (rng.standard_normal((RANKS,) + SHAPE) * 0.01).astype(np.float32)
    np.savez(os.path.join(d, "inputs.npz"), g=g, r=r)
    port, ref = _port_state(1), _reference_state(2)
    checkpoint.save(os.path.join(d, "port"), 7, port)
    jckpt.save(os.path.join(d, "reference"), 7, ref)
    np.savez(os.path.join(d, "stored_port.npz"), **{
        k: _bits(v) for k, v in checkpoint._flatten(port).items()})
    np.savez(os.path.join(d, "stored_reference.npz"), **{
        k: _bits(v) for k, v in jckpt._flatten(ref).items()})
    port_no = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, d],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _RANK, d, str(i), str(port_no)],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(RANKS)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]


def _build_mesh(d: str) -> None:
    """The four ranks of the (2, 2) mesh, every config in turn; rank 0
    writes each config's gathered results."""
    port_no = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_RANK, d, str(i), str(port_no),
         os.path.dirname(os.path.abspath(__file__))],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(RANKS)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = once(tmp_path_factory, "torch_dist", _build)
    z = np.load(os.path.join(d, "inputs.npz"))

    def load(name):
        return dict(np.load(os.path.join(d, name)))

    return {"inputs": (z["g"], z["r"]),
            "stored": {w: load(f"stored_{w}.npz")
                       for w in ("port", "reference")},
            "ref": load("reference.npz"),
            "ranks": [load(f"rank{i}.npz") for i in range(RANKS)]}


def _formula(g, r):
    """The reference's arithmetic in numpy, rank by rank: (total,
    residuals)."""
    gf = g + r if r is not None else g.copy()
    f32 = np.float32
    scale = np.maximum(np.abs(gf).reshape(RANKS, -1).max(1),
                       f32(1e-12)) / f32(127.0)
    codes = np.clip(np.round(gf / scale[:, None, None]), -127,
                    127).astype(np.int8)            # int8, as the reference
    res = gf - codes.astype(f32) * scale[:, None, None]
    smax = scale.max()
    q = np.round(codes.astype(f32) * (scale / smax)[:, None, None])
    total = q.astype(np.int32).sum(0).astype(f32) * smax
    return total, res


@pytest.mark.parametrize("case", ["none", "residual"])
def test_psum_compressed_equals_the_reference(run, case):
    ref = run["ref"]
    for i, got in enumerate(run["ranks"]):
        for part in ("total", "residual"):
            a, b = got[f"{case}_{part}"], ref[f"{case}_{part}"][i]
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
                (i, part)


@pytest.mark.parametrize("case", ["none", "residual"])
def test_psum_compressed_equals_the_formula(run, case):
    g, r = run["inputs"]
    total, res = _formula(g, r if case == "residual" else None)
    for i, got in enumerate(run["ranks"]):
        assert np.array_equal(got[f"{case}_total"], total), i
        assert np.array_equal(got[f"{case}_residual"], res[i]), i


@pytest.mark.parametrize("which", ["port", "reference"])
def test_sharded_restore_gathers_bit_for_bit(run, which):
    stored = run["stored"][which]
    got = {k[len(which) + 6:]: v for k, v in run["ranks"][0].items()
           if k.startswith(f"{which}/full/")}
    assert sorted(got) == sorted(stored)
    for k, want in stored.items():
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k


@pytest.mark.parametrize("which", ["port", "reference"])
def test_sharded_restore_keeps_only_local_shards(run, which):
    """On the (2, 2) mesh each rank holds its own shard of every array:
    the parameters' by the rule engine's specs (a stacked leaf's layers
    without the leading entry), the moments' with ZeRO-1's "data" on the
    stacked layer dim (2 layers)."""
    from repro_torch.launch.sharding import ShardingReport, spec_for

    class Mesh:
        shape = {"data": 2, "model": 2}

    def local_shape(shape, spec):
        return [n // (Mesh.shape[ax] if ax else 1) for n, ax in
                zip(shape, list(spec) + [None] * len(shape))]

    stored = run["stored"][which]
    for rank in run["ranks"]:
        shapes = {k[len(which) + 7:]: v for k, v in rank.items()
                  if k.startswith(f"{which}/shape/")}
        assert sorted(shapes) == sorted(stored)
        for k, full in stored.items():
            if k == "opt/step":
                assert list(shapes[k][0]) == []
                continue
            path = k.split("/", 2)[2] if k.startswith("opt/") \
                else k.split("/", 1)[1]
            spec = list(spec_for(path, full.ndim, Mesh, ShardingReport(),
                                 shape=full.shape))
            if k.startswith("opt/") and spec and spec[0] is None \
                    and full.shape[0] % 2 == 0:
                spec[0] = "data"                                # ZeRO-1
            want = local_shape(full.shape, spec)
            if k.startswith("train/stack/"):
                want = want[1:]
            assert all(list(s) == want for s in shapes[k]), (k, want)


# --- the sharded model path on values ---------------------------------------

@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    return once(tmp_path_factory, "torch_dist_mesh", _build_mesh)


_PLAIN: dict = {}


def _plain(arch: str) -> dict:
    if arch not in _PLAIN:
        _PLAIN[arch] = torch_mesh_drive.drive(arch)
    return _PLAIN[arch]


TOL = 1e-5
# The MoE configs' einsum dispatch rounds its float32 input to bf16, as the
# reference's does: a last-bit difference in that input (the mesh sums its
# partial products in another order) moves one rounding by a bf16 ulp,
# 2**-8 of the element. Downstream of the first MoE layer, the caches, the
# gradients' norm and the moments are held for these configs at a quarter
# of that ulp of their largest magnitude; the loss, the logits and the
# updated parameters at TOL as for every other config.
MOE_NORMWISE = 2.0 ** -10
PARTS = {"loss": ("loss",),
         "serve": ("prefill/", "decode/", "decode_placed/"),
         "train": ("train/",)}


def _bf16_bound(arch: str, key: str) -> bool:
    return pconfigs.get_config(arch).moe is not None and (
        "/caches/" in key or key == "train/grad_norm"
        or key.startswith(("train/mu/", "train/nu/")))


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_sharded_model_matches_one_process(mesh_run, arch, part):
    got = dict(np.load(os.path.join(mesh_run, f"{arch}.npz")))
    want = _plain(arch)
    assert sorted(k for k in got if not k.startswith("moe_layer/")) \
        == sorted(want)
    keys = [k for k in want if k.startswith(PARTS[part])]
    assert keys
    for k in keys:
        a, b = got[k], want[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if not np.issubdtype(b.dtype, np.floating):
            assert np.array_equal(a, b), k
            continue
        atol = MOE_NORMWISE * float(np.max(np.abs(b))) \
            if _bf16_bound(arch, k) else TOL
        np.testing.assert_allclose(a, b, rtol=TOL, atol=atol, err_msg=k)
    if part == "train":
        assert got["train/step"] == 8 and got["train/skipped"] == 0


@pytest.mark.parametrize("arch", [a for a in pconfigs.ARCH_IDS
                                  if pconfigs.get_config(a).moe is not None])
def test_sharded_moe_layer_matches_one_process(mesh_run, arch):
    """One MoE layer on the same input: each device's own tokens against
    its own experts (the experts' offsets, the partial sums over "model",
    the aux term split over the devices) at TOL; the input's gradient,
    whose per-device partial sums the bf16 dispatch rounds before the
    devices add them, at one bf16 ulp of its largest magnitude."""
    got = dict(np.load(os.path.join(mesh_run, f"{arch}.npz")))
    want = torch_mesh_drive.moe_layer(arch)
    assert sorted(k[len("moe_layer/"):] for k in got
                  if k.startswith("moe_layer/")) == sorted(want)
    for k, b in want.items():
        a = got["moe_layer/" + k]
        atol = 2.0 ** -8 * float(np.max(np.abs(b))) if k == "grad/x" \
            else TOL
        np.testing.assert_allclose(a, b, rtol=TOL, atol=atol, err_msg=k)
