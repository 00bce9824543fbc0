"""Multi-card dry-run: trace every (arch × shape × mesh) cell on a fake
process group (port of ``repro.launch.dryrun``).

For each cell this builds the real step (``train.make_train_step``'s step:
forward, backward, AdamW; ``models.prefill``; ``models.decode_step``), the
full sharding trees from the rule engine (``launch.sharding``), places the
model, optimizer state, batch and caches as DTensors on the production
mesh, and runs the step once in one process: a fake process group of
``prod(mesh)`` ranks (rank 0; collectives return at once) under
``FakeTensorMode`` (no allocation). It records per device, from the local
ops that DTensor runs on rank 0's shards:

- flops: 2·|result|·|contracted| of every matmul-family op (the registry of
  ``torch.utils.flop_counter``), counted on the *local* ops: a counter
  outside DTensor sees the global op, whose count divided by the cards is
  wrong wherever compute is replicated;
- HBM bytes: operands plus results of every local aten op that is not a
  view. Nothing is fused here, so this over-counts what the card moves,
  as the reference's XLA:CPU byte count over-counts a TPU's;
- collectives by kind, with link bytes by the reference's ring factors
  (``roofline.collective_bytes``), from the functional collectives that
  DTensor issues. On a ``cpu`` mesh DTensor replaces an all-to-all by an
  all-gather and a chunk, so such a redistribution counts as an
  all-gather;
- peak live bytes: the arguments' shards plus every local op's results
  while their storage lives. The models run their plain versions here
  (the kernels need the card), and plain attention materializes its (Sq,
  Sk) scores, which the flash kernel never does: the peak counts them.

The ops DTensor runs on global shapes to propagate shapes are not
counted.

Layers are Python loops and every layer is traced, so nothing needs the
trip-count scaling of the reference's ``hlo_analysis.py``. Where DTensor
cannot carry a sharding through a view, the models gather explicitly
(``models.common.REDISTRIBUTED``); the record lists each such
redistribution (``redistributed_views``), which XLA makes silently.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import time
import traceback
import weakref

import numpy as np
import torch

from ..configs import ARCH_IDS, SHAPES, get_config, skip_reason
from . import roofline as rl
from .mesh import production_shape
from .sharding import (batch_shardings, cache_shardings,
                       distribute_model, opt_shardings, param_shardings,
                       placements, serving_shardings,
                       sharded_bytes_per_device)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _leaf(shape, dtype):
    from ..train.step import Leaf
    return Leaf(shape, dtype)


def batch_struct(cfg, batch: int, seq: int) -> dict:
    """Shape and dtype records of every model input."""
    i64, f32 = torch.int64, torch.float32
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": _leaf((batch, seq, cfg.d_model), f32),
                "labels": _leaf((batch, seq, cfg.n_codebooks), i64),
                "mask": _leaf((batch, seq), f32)}
    if cfg.frontend == "vision_patches":
        text = seq - cfg.n_patches
        return {"tokens": _leaf((batch, text), i64),
                "patch_embeds": _leaf((batch, cfg.n_patches, cfg.d_model),
                                      f32),
                "labels": _leaf((batch, text), i64),
                "mask": _leaf((batch, text), f32)}
    return {"tokens": _leaf((batch, seq), i64),
            "labels": _leaf((batch, seq), i64),
            "mask": _leaf((batch, seq), f32)}


def decode_token_struct(cfg, batch: int) -> dict:
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": _leaf((batch, 1, cfg.d_model),
                                      torch.float32)}
    return {"tokens": _leaf((batch, 1), torch.int64)}


def _place(struct: dict, shardings: dict, mesh) -> dict:
    """Zero DTensors of each record's shape and dtype, on its spec."""
    from torch.distributed import tensor as dt
    return {k: dt.zeros(v.shape, dtype=v.dtype, device_mesh=mesh,
                        placements=placements(shardings[k].spec, mesh))
            for k, v in struct.items()}


def _distribute_tree(tree: dict, shardings: dict, mesh) -> dict:
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, shardings[k], mesh)
                for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements(shardings.spec, mesh),
                             src_data_rank=None)


def build_cell(cfg, shape, mesh):
    """Returns (fn, args, ShardingReport, byte accounting, extras): ``fn
    (*args)`` runs the cell's step on DTensors. Build under a
    ``FakeTensorMode`` (the model at full width allocates nothing there).
    The byte accounting is the reference's, from the specs and the
    reference-layout shapes; ``extras["serving_buffers_per_device"]``
    counts the port's float32 serving heads apart."""
    from ..models import (decode_step, init_caches, init_params, param_tree,
                          prefill)
    from ..optim import adamw
    from ..train.step import (init_sharded_train_state, make_train_step,
                              opt_layout)

    model = init_params(cfg, 0, device="cpu")
    p_shard, report = param_shardings(cfg, mesh, model)
    serving = serving_shardings(model, p_shard)
    bytes_acct = {"params_per_device": sharded_bytes_per_device(
        param_tree(model), p_shard, mesh)}
    extras = {"serving_buffers_per_device": sharded_bytes_per_device(
        {k: getattr(model, k) for k in serving}, serving, mesh)}
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        layout = opt_layout(model)
        o_shard = opt_shardings(mesh, layout, p_shard)
        bytes_acct["opt_per_device"] = sharded_bytes_per_device(
            layout, o_shard, mesh)
        # min traffic: params fwd+bwd reads + grad write + moments r/w
        bytes_acct["ideal_step_bytes"] = (
            3 * bytes_acct["params_per_device"]
            + 2 * bytes_acct["opt_per_device"])
        distribute_model(model, mesh, p_shard, serving)
        opt = init_sharded_train_state(model, o_shard)
        bs = batch_struct(cfg, B, S)
        batch = _place(bs, batch_shardings(mesh, bs, B), mesh)
        step = make_train_step(cfg, adamw.AdamWConfig(), lambda s: 1.0)
        return step, (model, opt, batch), report, bytes_acct, extras

    caches = init_caches(cfg, B, S, "cpu")
    c_shard = cache_shardings(mesh, caches, B)
    bytes_acct["cache_per_device"] = sharded_bytes_per_device(
        caches, c_shard, mesh)
    bytes_acct["ideal_step_bytes"] = (
        bytes_acct["params_per_device"] + bytes_acct["cache_per_device"])
    distribute_model(model, mesh, p_shard, serving)

    if shape.kind == "prefill":
        bs = batch_struct(cfg, B, S)
        bs.pop("labels", None)
        bs.pop("mask", None)
        batch = _place(bs, batch_shardings(mesh, bs, B), mesh)

        def run_prefill(m, b):
            return prefill(cfg, m, b, max_cache_len=S, device="cpu")
        return run_prefill, (model, batch), report, bytes_acct, extras

    # decode: one new token against a seq_len-deep cache
    ts = decode_token_struct(cfg, B)
    tok = _place(ts, batch_shardings(mesh, ts, B), mesh)
    caches = _distribute_tree(caches, c_shard, mesh)

    def run_decode(m, t, c):
        return decode_step(cfg, m, t, S - 1, c, device="cpu")
    return run_decode, (model, tok, caches), report, bytes_acct, extras


# ---------------------------------------------------------------------------
# Counters over the local ops
# ---------------------------------------------------------------------------

_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "detach", "alias",
               "_unsafe_view", "wait_tensor")


def _tensors(tree):
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _group_size(name: str, default: int) -> int:
    try:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(name).size()
    except Exception:                                     # noqa: BLE001
        return default


_PROPAGATION = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


class CostMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Per-device flops, HBM bytes, collective records and peak live bytes
    of the local ops: on a DTensor op it returns ``NotImplemented``, so
    that DTensor runs first and hands the mode its local ops and
    collectives. ``track`` counts tensors that live before the run (the
    arguments' shards) in the live bytes."""

    def __init__(self, n_devices: int):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.n_devices = n_devices
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: list = []      # (kind, result bytes, group size)
        self.live = self.peak = 0
        self._storages: dict = {}        # id(storage): bytes
        self._quiet = 0
        self._patched: list = []

    def track(self, t) -> None:
        st = t.untyped_storage()
        if id(st) in self._storages:
            return
        self._storages[id(st)] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, id(st))

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def __enter__(self):
        # DTensor runs each new op once on global shapes to learn its
        # output's shape: not the device's work
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as prop
        for name in _PROPAGATION:
            orig = getattr(prop, name, None)
            if orig is None:
                continue

            def quiet(*a, _orig=orig, **k):
                self._quiet += 1
                try:
                    return _orig(*a, **k)
                finally:
                    self._quiet -= 1
            setattr(prop, name, quiet)
            self._patched.append((prop, name, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        for owner, name, orig in self._patched:
            setattr(owner, name, orig)
        self._patched.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        tensors = _tensors((args, kwargs, out))
        packet = func._overloadpacket
        ns, name = packet._qualified_op_name.split("::")
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                # the group's name is the last string argument
                group = [a for a in args if isinstance(a, str)][-1]
                nbytes = sum(t.numel() * t.element_size()
                             for t in _tensors(out))
                self.collectives.append(
                    (kind, nbytes, _group_size(group, self.n_devices)))
            for t in _tensors(out):
                self.track(t)
            return out
        if packet in self.registry:
            self.flops += float(self.registry[packet](*args, **kwargs,
                                                       out_val=out))
        if not func.is_view and name not in _NO_TRAFFIC:
            self.hbm_bytes += sum(t.numel() * t.element_size()
                                  for t in tensors)
        for t in _tensors(out):
            self.track(t)
        return out


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake process group of ``n`` ranks in this process, as ``rank``
    (its collectives return at once, without data), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_dims(mesh_kind: str) -> tuple[tuple, tuple]:
    """(shape, axis names) of ``single``, ``multi`` or ``<d>x<m>``."""
    custom = re.match(r"^(\d+)x(\d+)$", mesh_kind)
    if custom:                            # e.g. --mesh 32x8 (layout study)
        return ((int(custom.group(1)), int(custom.group(2))),
                ("data", "model"))
    return production_shape(multi_pod=(mesh_kind == "multi"))


def _redistributed() -> list:
    from ..models.common import REDISTRIBUTED
    return [{"path": k[0], "op": k[1], "shape": list(k[2]), "from": k[3],
             "to": k[4], "count": n} for k, n in REDISTRIBUTED.items()]


def trace_cell(cfg, shape, mesh, n_dev: int) -> dict:
    """Build and run one cell on ``mesh`` (a fake world of ``n_dev``
    ranks); → the record's measured fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from ..models.common import REDISTRIBUTED

    REDISTRIBUTED.clear()
    t0 = time.time()
    with FakeTensorMode(), implicit_replication():
        fn, args, report, bytes_acct, extras = build_cell(cfg, shape, mesh)
        t1 = time.time()
        costs = CostMode(n_dev)
        for t in (*_tensors(args[1:]), *args[0].parameters(),
                  *args[0].buffers()):
            costs.track(t.to_local() if hasattr(t, "to_local") else t)
        arguments = costs.live
        with costs:
            fn(*args)
        t2 = time.time()
        mem_rec = {"argument_bytes": arguments,
                   "peak_live_bytes": costs.peak}
    model_flops = rl.analytic_model_flops(cfg, shape.kind, shape.seq_len,
                                          shape.global_batch)
    coll = rl.collective_bytes(costs.collectives, n_dev)
    roof = rl.Roofline(flops=costs.flops, hbm_bytes=costs.hbm_bytes,
                       link_bytes=coll["total"], chips=n_dev,
                       model_flops=model_flops)
    return {
        "status": "ok",
        "build_s": round(t1 - t0, 2),
        "trace_s": round(t2 - t1, 2),
        "flops_per_device": roof.flops,
        "hbm_bytes_per_device": roof.hbm_bytes,
        "link_bytes_per_device": roof.link_bytes,
        "collectives": coll,
        "model_flops": model_flops,
        "t_compute": roof.t_compute,
        "t_memory": roof.t_memory,
        "t_collective": roof.t_collective,
        "bottleneck": roof.bottleneck,
        "roofline_fraction": roof.roofline_fraction,
        "flops_utilization": roof.flops_utilization,
        "bytes_accounting": {k: float(v) for k, v in bytes_acct.items()},
        "serving_buffers_per_device": float(
            extras["serving_buffers_per_device"]),
        "memory_fraction": float(bytes_acct["ideal_step_bytes"]
                                 / max(roof.hbm_bytes, 1.0)),
        # score-carrying fraction: ideal time (compute OR unavoidable
        # memory, whichever binds) over the achieved bound
        "roofline_fraction_cell": float(
            max(model_flops / n_dev / rl.PEAK_FLOPS,
                bytes_acct["ideal_step_bytes"] / rl.HBM_BW)
            / max(roof.bound_time, 1e-30)),
        "memory_analysis": mem_rec,
        "sharding_report": {
            "matched": report.matched,
            "fallback_replicated": report.fallback_replicated[:20],
            "degraded_dims": [list(map(str, d))
                              for d in report.degraded_dims[:20]],
        },
        "redistributed_views": _redistributed(),
        "constants": {"constants_for": "H100 SXM5 datasheet",
                      "peak_flops": rl.PEAK_FLOPS, "hbm_bw": rl.HBM_BW,
                      "link_bw": rl.LINK_BW},
    }


def _config(arch: str, overrides: dict | None):
    flat = {k: v for k, v in (overrides or {}).items() if "." not in k}
    nested = {k: v for k, v in (overrides or {}).items() if "." in k}
    cfg = get_config(arch, **flat)
    for k, v in nested.items():           # e.g. --override moe.impl=gather
        head, leaf = k.split(".", 1)
        sub = getattr(cfg, head)
        cfg = dataclasses.replace(
            cfg, **{head: dataclasses.replace(sub, **{leaf: v})})
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, tag: str = "",
             out_dir: str = OUT_DIR, shape=None) -> dict:
    """One cell in a fake world of its own, created here and destroyed
    after it; the record is written to ``out_dir`` and returned.
    ``shape`` replaces ``SHAPES[shape_name]`` (a cut-down cell)."""
    shape = shape or SHAPES[shape_name]
    reason = skip_reason(arch, shape_name)
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{arch}__{shape_name}__{mesh_kind}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, stem + ".json")
    if reason:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": reason}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    dims, names = mesh_dims(mesh_kind)
    n_dev = int(np.prod(dims))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
           "devices": n_dev, "overrides": {k: str(v) for k, v in
                                           (overrides or {}).items()}}
    try:
        cfg = _config(arch, overrides)
        with fake_world(n_dev):
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
            rec.update(trace_cell(cfg, shape, mesh, n_dev))
    except Exception as e:                                # noqa: BLE001
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-3000:]})
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    help="single | multi | both | <data>x<model> (e.g. 32x8)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--override", action="append",
                    help="cfg field override, e.g. --override remat=false")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    overrides = _parse_overrides(args.override)

    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                stem = f"{arch}__{shape}__{mesh_kind}" \
                    + (f"__{args.tag}" if args.tag else "")
                path = os.path.join(args.out, stem + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip-existing] {stem}")
                    continue
                t0 = time.time()
                rec = run_cell(arch, shape, mesh_kind, overrides, args.tag,
                               args.out)
                status = rec["status"]
                if status == "ok":
                    extra = (f"bottleneck={rec['bottleneck']} "
                             f"frac={rec['roofline_fraction_cell']:.3f} "
                             f"trace={rec['trace_s']}s")
                elif status == "error":
                    extra = rec["error"][:160]
                else:
                    extra = rec["reason"][:60]
                print(f"[{status:7s}] {stem} ({time.time()-t0:.0f}s) {extra}",
                      flush=True)


if __name__ == "__main__":
    main()
