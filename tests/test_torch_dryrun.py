"""The port's dry-run (``repro_torch.launch.{dryrun,roofline}``) against the
JAX package's: counterparts of ``tests/test_system.py``'s 40-cell matrix
and lazy mesh builders; ``build_cell``'s byte accounting equal to the
reference's ``build_cell`` (built only: no lowering, no compile) for
qwen3-4b's train, prefill and decode cells, one MoE and one recurrent
config, at the smoke size on (2, 4); the train cell of all ten configs at
the smoke size on (2, 4) reporting ``status ok``; per-device flops exact
on a loop of sharded matmuls (the counterpart of
``test_loop_scaling_exact_on_scanned_matmul``); the ring factors against
the reference's ``HloModule`` on ``test_collective_ring_factors_
synthetic``'s HLO; ``analytic_model_flops`` equal to the reference's for
every cell. The reference's dry-run sets ``XLA_FLAGS`` when imported, so
it runs in a subprocess; each port cell runs in a fake process group of
its own, destroyed after it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch.hlo_analysis import HloModule  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402

from torch_once import once  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMOKE = {"batch": 8, "seq": 32}
BYTES_CELLS = [("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
               ("qwen3-4b", "decode_32k"),
               ("deepseek-v2-lite-16b", "train_4k"),
               ("falcon-mamba-7b", "train_4k")]
# cells whose traced per-device flops equal the reference dry-run's on
# (2, 4): qwen3-4b's and starcoder2-7b's 2 kv heads do not split over the
# model axis of 4 (each is repeated twice), musicgen-medium's 4 do
FLOP_CELLS = [("qwen3-4b", "prefill_32k"), ("starcoder2-7b", "prefill_32k"),
              ("musicgen-medium", "prefill_32k")]


def smoke_shape(shape_name: str):
    return dataclasses.replace(pconfigs.SHAPES[shape_name],
                               seq_len=SMOKE["seq"],
                               global_batch=SMOKE["batch"])


def test_applicability_matrix_covers_40_cells():
    cells = [(a, s) for a in pconfigs.ARCH_IDS for s in pconfigs.SHAPES]
    assert len(cells) == 40
    skips = [c for c in cells if not pconfigs.applicable(*c)]
    assert len(skips) == 6                       # DESIGN.md §5
    assert all(s == "long_500k" for _, s in skips)
    assert all(pconfigs.skip_reason(a, s) for a, s in skips)
    assert cells == [(a, s) for a in jconfigs.ARCH_IDS
                     for s in jconfigs.SHAPES]
    assert all(pconfigs.skip_reason(*c) == jconfigs.skip_reason(*c)
               for c in cells)


def test_production_mesh_builders_are_lazy():
    """Importing mesh.py (and the dry-run) starts no process group and
    sets no ``XLA_FLAGS``; the builders keep the reference's shapes."""
    import inspect
    from repro_torch.launch import mesh as mesh_mod
    code = ("import os, torch.distributed as dist, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized()\n"
            "assert 'XLA_FLAGS' not in os.environ\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    src = inspect.getsource(mesh_mod)
    assert "(2, 16, 16)" in src and "(16, 16)" in src and '"pod"' in src
    assert dryrun.mesh_dims("single") == ((16, 16), ("data", "model"))
    assert dryrun.mesh_dims("multi") == ((2, 16, 16),
                                         ("pod", "data", "model"))
    assert dryrun.mesh_dims("32x8") == ((32, 8), ("data", "model"))


# --- byte accounting against the reference's build_cell ---------------------

_REFERENCE_BYTES = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import SHAPES, get_config
from repro.launch import roofline as rl
from repro.launch.dryrun import build_cell
cells, flop_cells, batch, seq = json.loads(sys.stdin.read())
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {"bytes": {}, "flops": {}}
with mesh:
    for arch, shape_name in cells + flop_cells:
        shape = dataclasses.replace(SHAPES[shape_name], seq_len=seq,
                                    global_batch=batch)
        fn, args, report, acct = build_cell(get_config(arch, smoke=True),
                                            shape, mesh)
        key = f"{arch}/{shape_name}"
        if [arch, shape_name] in cells:
            out["bytes"][key] = {k: float(v) for k, v in acct.items()}
        if [arch, shape_name] in flop_cells:
            # the reference dry-run's cost analysis of the compiled cell
            compiled = fn.lower(*args).compile()
            roof, _ = rl.from_compiled(compiled, 8, 1.0,
                                       hlo_text=compiled.as_text())
            out["flops"][key] = roof.flops
print(json.dumps(out))
"""


def _reference_bytes(d: str) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_BYTES],
        input=json.dumps([BYTES_CELLS, FLOP_CELLS, SMOKE["batch"],
                          SMOKE["seq"]]),
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(d, "bytes.json"), "w") as f:
        f.write(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference_bytes(tmp_path_factory):
    d = once(tmp_path_factory, "torch_dryrun_bytes", _reference_bytes)
    with open(os.path.join(d, "bytes.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape_name", BYTES_CELLS)
def test_bytes_accounting_equals_the_reference(reference_bytes, arch,
                                               shape_name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    cfg = pconfigs.get_config(arch, smoke=True)
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            _, _, _, acct, extras = dryrun.build_cell(
                cfg, smoke_shape(shape_name), mesh)
    assert acct == reference_bytes["bytes"][f"{arch}/{shape_name}"]
    assert extras["serving_buffers_per_device"] > 0


@pytest.mark.parametrize("arch,shape_name", FLOP_CELLS)
def test_flops_per_device_equal_the_reference(reference_bytes, tmp_path,
                                              arch, shape_name):
    """The traced per-device flops of a smoke cell on (2, 4) equal the
    reference dry-run's cost analysis of the same compiled cell: the
    counter's matmul flops on the local ops, and the sharded path's
    partition of the work, XLA's."""
    rec = dryrun.run_cell(arch, shape_name, "2x4", {"smoke": True},
                          out_dir=str(tmp_path),
                          shape=smoke_shape(shape_name))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops_per_device"] == \
        reference_bytes["flops"][f"{arch}/{shape_name}"]


# --- the train cell of every config ------------------------------------------

@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_train_cell_reports_ok(tmp_path, arch):
    rec = dryrun.run_cell(arch, "train_4k", "2x4", {"smoke": True},
                          out_dir=str(tmp_path),
                          shape=smoke_shape("train_4k"))
    assert rec["status"] == "ok", rec.get("traceback")
    with open(tmp_path / f"{arch}__train_4k__2x4.json") as f:
        assert json.load(f)["status"] == "ok"
    assert rec["devices"] == 8
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert rec["memory_analysis"]["peak_live_bytes"] > 0
    assert not rec["sharding_report"]["fallback_replicated"]
    for r in rec["redistributed_views"]:
        assert r["count"] > 0 and r["from"] != r["to"]
    assert set(rec["bytes_accounting"]) == {
        "params_per_device", "opt_per_device", "ideal_step_bytes"}


def test_main_records_a_skipped_cell(tmp_path, capsys):
    dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k", "--mesh",
                 "single", "--out", str(tmp_path)])
    assert "[skipped] qwen3-4b__long_500k__single" in capsys.readouterr().out
    with open(tmp_path / "qwen3-4b__long_500k__single.json") as f:
        assert json.load(f)["status"] == "skipped"


# --- the counters and the roofline -----------------------------------------

def test_loop_scaling_exact_on_sharded_matmul():
    """An L-layer loop of column-sharded matmuls on (2, 4), each layer's
    output gathered: every device does 2·L·B·D·D / model flops (the batch
    replicated over "data"), and one all-gather of (B, D) over the 4 ranks
    of "model" per layer."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    L, B, D = 6, 8, 64
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.zeros(B, D), mesh,
                                  [Replicate(), Replicate()],
                                  src_data_rank=None)
            ws = [distribute_tensor(torch.zeros(D, D), mesh,
                                    [Replicate(), Shard(1)],
                                    src_data_rank=None) for _ in range(L)]
            costs = dryrun.CostMode(8)
            with costs:
                for w in ws:
                    x = torch.tanh(x @ w).redistribute(
                        mesh, [Replicate(), Replicate()])
    assert costs.flops == 2 * L * B * D * D / 4
    kinds = [k for k, _, _ in costs.collectives]
    assert kinds == ["all-gather"] * L
    assert all(n == 4 and b == B * D * 4 for _, b, n in costs.collectives)


def test_collective_ring_factors_equal_the_reference():
    hlo = """
ENTRY %main (p: f32[64]) -> f32[64] {
  %p = f32[64]{0} parameter(0)
  %ar = f32[64]{0} all-reduce(%p), replica_groups=[2,4]<=[8], to_apply=%add
  ROOT %ag = f32[256]{0} all-gather(%ar), replica_groups=[2,4]<=[8], dimensions={0}
}
"""
    ref = HloModule(hlo, 8).entry_cost().coll
    got = roofline.collective_bytes(
        [("all-reduce", 256, 4), ("all-gather", 1024, 4)], 8)
    assert got["all-reduce"] == ref["all-reduce"] == 2 * 256 * 3 / 4
    assert got["all-gather"] == ref["all-gather"] == 1024 * 3 / 4
    one = roofline.collective_bytes([("reduce-scatter", 64, 4),
                                     ("all-to-all", 64, 4),
                                     ("collective-permute", 64, 2),
                                     ("all-reduce", 64, 1)], 8)
    assert one["reduce-scatter"] == 64 * 3
    assert one["all-to-all"] == 64 * 3 / 4
    assert one["collective-permute"] == 64 and one["all-reduce"] == 0
    assert one["counts"]["all-reduce"] == 0
    assert one["total"] == 64 * 3 + 48 + 64


def test_counter_sees_dtensor_collectives():
    """A pending sum over "model" reduced to replicated is one all-reduce
    of the local shard over the 4 ranks of that dim."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            y = DTensor.from_local(torch.zeros(4, 16), mesh,
                                   [Shard(0), Partial()], run_check=False)
            costs = dryrun.CostMode(8)
            with costs:
                y.redistribute(mesh, [Shard(0), Replicate()])
    assert costs.collectives == [("all-reduce", 4 * 16 * 4, 4)]
    assert roofline.collective_bytes(costs.collectives, 8)["total"] == \
        2 * 256 * 3 / 4


def test_roofline_terms_use_the_h100_constants():
    r = roofline.Roofline(flops=989e12, hbm_bytes=3.35e12 * 2,
                          link_bytes=450e9 * 3, chips=4,
                          model_flops=4 * 989e12 / 2)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 3.0)
    assert r.bottleneck == "collective" and r.bound_time == 3.0
    assert r.roofline_fraction == pytest.approx(0.5 / 3.0)
    assert r.flops_utilization == pytest.approx(0.5)


@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_analytic_model_flops_equal_the_reference(arch):
    for name, shape in pconfigs.SHAPES.items():
        got = roofline.analytic_model_flops(
            pconfigs.get_config(arch), shape.kind, shape.seq_len,
            shape.global_batch)
        want = jroofline.analytic_model_flops(
            jconfigs.get_config(arch), shape.kind, shape.seq_len,
            shape.global_batch)
        assert got == want, name
