#!/usr/bin/env python3
"""Host time of the PIM path's entries on one card, broken down.

    PYTHONPATH=src python tools/pim_dispatch_breakdown.py [--label NAME]
        [--out FILE.json]

Measures whichever ``repro_torch`` comes first on ``PYTHONPATH``, so that
one script times two trees (an older checkout unpacked beside this one:
``PYTHONPATH=<old>/src python tools/pim_dispatch_breakdown.py --label
old``). The inputs are ``chip_smoke.py``'s, imported from this script's
checkout: ``execute(shift_workload(1000))`` on a 512 x 2,048 subarray;
phase 4's first ``schedule()`` step, a 16-step ``schedule_pipeline`` of its
second layout and a 3-phase ``schedule_workload`` of its three layouts,
back to back and interleaved, on ``paper_device(32, subarrays=2)``; a
single-bank VM's ``run_pipeline`` (four ripple adds) and ``run_workload``
(those and three xtime steps) at phase 10's row size, which reach
``exec``'s pipeline and workload runners; the serving front's 16 steps
(phase 14) and one ``mul_shift_add`` on 8 KB rows (phase 10).

For each entry: the host ms of the first call, the second and the median of
the next five (each ending in ``torch.cuda.synchronize()``); then one more
call with the scheduler's and executor's stages wrapped in host-clock timers
(lowering: layout checks, copy stripping, grouping and compiles; planning:
the step-plan lookup or build; payloads: stacking and uploading the HOSTW
data; launches: the row-entry and meter-fold wrappers, each a ctypes
launch; copies: clones, copies, gathers and scatters of rows and meters;
replay: ``CUDAGraph.replay``; other: the rest of the call), and one under
``torch.profiler``: the card's kernel ms, the kernel-launch calls and the
``cudaGraphLaunch`` calls. Prints one line per entry and the card's name and
power limit, and with ``--out`` writes the whole record there as JSON.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARM = 5


class Stages:
    """Host-clock time by stage within ``with``: the listed functions are
    wrapped; a call made inside another timed call counts as the outer
    one's stage."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.ms = {}
        self._stack = []

    def _wrap(self, stage, fn):
        def timed(*a, **kw):
            if self._stack:
                return fn(*a, **kw)
            self._stack.append(stage)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.ms[stage] = (self.ms.get(stage, 0.0)
                                  + (time.perf_counter() - t) * 1e3)
                self._stack.pop()
        return timed

    def __enter__(self):
        self._saved = []
        for stage, owner, name in self.targets:
            if hasattr(owner, name):
                own = owner.__dict__.get(name)
                self._saved.append((owner, name, own))
                setattr(owner, name, self._wrap(stage, getattr(owner, name)))
        return self

    def __exit__(self, *exc):
        for owner, name, own in reversed(self._saved):
            if own is None:             # inherited: drop the wrapper
                delattr(owner, name)
            else:
                setattr(owner, name, own)
        return False


def stage_targets(torch):
    from repro_torch.core.pim import exec as pim_exec
    from repro_torch.kernels.rowops import ops
    sched = importlib.import_module("repro_torch.core.pim.schedule")
    out = [("lowering", sched, n) for n in (
        "_lower_step", "_lower_recurring", "_compiled_for", "_split_copies",
        "_normalize_programs")]
    out += [("lowering", pim_exec, "compile_program"),
            ("planning", sched, "_plan_for"),
            ("planning", sched, "_workload_plan")]
    out += [("payloads", sched, n) for n in (
        "_step_payloads", "_steps_payloads", "_payload_stack")]
    out += [("launches", ops, n) for n in (
        "bitwise_rows", "shift_rows", "meter_fold")]
    out += [("copies", torch.Tensor, n) for n in (
        "clone", "copy_", "index_select", "index_copy", "index_copy_",
        "__setitem__")]
    out += [("copies", torch, "stack"),
            ("replay", torch.cuda.CUDAGraph, "replay")]
    return out


def entries(torch, device, cs):
    """name -> (call, its input) on the card."""
    import numpy as np
    from repro_torch.core import pim
    from repro_torch.core.bitplane import PimVM, arith
    cfg = pim.paper_device(32, subarrays=2)
    steps = cs.device_steps(cfg)
    (l0, f0), (l1, _), _ = steps
    phases = [pim.Phase.repeat(lay, 2, async_host=bool(f.get("async_host")))
              for lay, f in steps]
    prog = pim.shift_workload_program(1000)
    sub = cs.subarray_state(torch, device)
    dev = cs.device_start(torch, device, cfg)
    workloads = cs.front_workloads(cfg, cs.FRONT_STEPS)
    vm = PimVM(width=8, num_rows=cs.VM_ROWS, words=cs.VM_WORDS,
               device=device)
    rng = np.random.default_rng(22)
    ra = vm.load(rng.integers(0, 256, vm.lanes))
    rb = vm.load(rng.integers(0, 256, vm.lanes))
    vm_pipe, vm_workload = cs.vm_graph_runs()
    vm1, vm2 = cs.vm_one_bank(device), cs.vm_one_bank(device)
    return {
        "execute(shift_workload(1000))": lambda: pim.execute(prog, sub),
        "schedule() step 1": lambda: pim.schedule(dev, l0, **f0),
        "schedule_pipeline 16 steps": lambda: pim.schedule_pipeline(
            dev, l1, n_steps=16, async_host=True),
        "schedule_workload 3 phases": lambda: pim.schedule_workload(
            dev, phases, refresh=True),
        "schedule_workload order=": lambda: pim.schedule_workload(
            dev, phases, order=(0, 1, 2, 0, 1, 2), refresh=True),
        "VM run_pipeline (1 bank)": lambda: vm_pipe(vm1),
        "VM run_workload (1 bank)": lambda: vm_workload(vm2),
        "front 16 steps": lambda: cs.run_front(torch, device, cfg,
                                               workloads),
        "mul_shift_add": lambda: vm.read(arith.mul_shift_add(vm, ra, rb)),
    }


def host_ms(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pim_dispatch_breakdown: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    # the package first, from PYTHONPATH: chip_smoke.py puts its own
    # checkout's src/ ahead on sys.path when imported
    import repro_torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    rec = {"label": args.label, "card": card,
           "package": str(Path(repro_torch.__file__).parent), "entries": {}}
    for name, fn in entries(torch, device, cs).items():
        times = [host_ms(torch, fn) for _ in range(2 + WARM)]
        with Stages(torch, stage_targets(torch)) as st:
            wall = host_ms(torch, fn)
        sh = cs.device_share(torch, fn)
        stages = dict(st.ms)
        stages["other"] = wall - sum(stages.values())
        r = dict(first_ms=times[0], second_ms=times[1],
                 warm_ms=statistics.median(times[2:]), warm_all=times[2:],
                 staged_ms=wall, stages=stages, kernel_ms=sh["device_ms"],
                 kernel_launches=sh["launch_calls"],
                 graph_launches=sh["graph_launches"])
        rec["entries"][name] = r
        print(f"{args.label} {name}: first {r['first_ms']:.2f} ms, second "
              f"{r['second_ms']:.2f}, warm {r['warm_ms']:.3f} (median of "
              f"{WARM}); staged call {wall:.2f} ms = " + ", ".join(
                  f"{k} {v:.2f}" for k, v in stages.items())
              + f"; kernels {r['kernel_ms']:.3f} ms, "
              f"{r['kernel_launches']} kernel launches, "
              f"{r['graph_launches']} graph launches", flush=True)
    print(f"{args.label} card: {card}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
