#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; exits non-zero, printing no result, without them. Phases, one line
each, every mismatch fatal:

1. build     — the CUDA kernels, from the sources in the checkout;
2. kernels   — each kernel against its plain torch version on the card,
               bit for bit, at the executor's shapes; device times (a CUDA
               graph of 20 launches, replayed 20 times, median) beside the
               plain version's, the memory-rate bound and the time of one
               call with the host's launch (CUDA events, median of 20);
3. subarray  — recorded programs through ``execute()`` at the paper's
               512 x 2,048 geometry, held exactly against the port's eager
               ISA on the card and ``execute()`` on the CPU;
4. device    — ``schedule()`` on ``paper_device(32, subarrays=2)`` (64
               slots, 256 MiB of rows on the card): heterogeneous programs,
               host writes and reads, a cross-bank COPY drain, two async
               steps (the second also refreshed), held exactly against the
               CPU run;
5. launches  — kernel launches over the main path of phases 3-4 (counts
               reset just before, read just after); each kernel must run.

Then the kernel table as JSON, the card's name and power limit, and the
result line. Nanoseconds and nanojoules of the DDR3 meter are outputs of
the simulated DRAM's model; milliseconds and microseconds are times of the
card. Everything measured is also written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA's data sheet (SXM)
H100_F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/rowops/csrc/rowops.cu"
REPLACES = {
    "shift_cols": "src/repro/kernels/rowops/rowops.py:137",
    "bitwise": "src/repro/kernels/rowops/rowops.py:120",
    "meter_fold": "src/repro/core/pim/compile.py:247",
}
SHIFT_KS = (1, -1, 31, 32, 33, -33, 999, -999, 65535, 65536, 70000)
OPS = ("not", "and", "or", "xor", "maj")


def say(line: str) -> None:
    print(line, flush=True)


@functools.lru_cache(maxsize=4)
def _seeded_rows(seed: int, shape):
    import numpy as np
    a = np.random.default_rng(seed).integers(0, 2**32, shape,
                                             dtype=np.uint32)
    a.setflags(write=False)
    return a.view(np.int32)


def rows_from_seed(seed: int, shape, torch, device):
    """int32 rows made by numpy from ``seed``, copied onto ``device``."""
    return torch.tensor(_seeded_rows(seed, tuple(shape)), device=device)


def event_us(fn, torch, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, in microseconds, host
    launch overhead included (the card waits for the host between the
    events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def device_us(fn, torch, per_graph: int = 20, reps: int = 20) -> float:
    """Device time of one call of ``fn``, in microseconds, without the
    host's launch overhead: ``per_graph`` calls captured in a CUDA graph,
    each replay timed with CUDA events, the median of ``reps`` replays
    divided by ``per_graph``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / per_graph)
    return statistics.median(times)


def max_abs_err(a, b):
    a, b = a.cpu(), b.cpu()
    if a.numel() == 0:
        return 0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return int((a.long() - b.long()).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(torch, device, n: int = 64, w: int = 2048):
    import numpy as np
    from repro_torch.core import pim
    from repro_torch.kernels.rowops import ops, ref

    x = rows_from_seed(1, (n, w), torch, device)
    b = rows_from_seed(2, (n, w), torch, device)
    c = rows_from_seed(3, (n, w), torch, device)
    x_cpu = x.cpu()
    err = {"shift_cols": 0, "bitwise[maj]": 0, "bitwise[not]": 0,
           "meter_fold": 0}
    for k in SHIFT_KS:
        got = ops.shift_cols(x, k).cpu()
        for exp in (ref.ref_shift_cols(x, k).cpu(),
                    ref.ref_shift_cols(x_cpu, k)):
            if not torch.equal(got, exp):
                raise AssertionError(f"shift_cols k={k} differs from plain")
            err["shift_cols"] = max(err["shift_cols"], max_abs_err(got, exp))
    for op in OPS:
        got = ops.bitwise(x, b, c, op=op)
        exp = ref.ref_bitwise(x, b, c, op=op)
        if not torch.equal(got, exp):
            raise AssertionError(f"bitwise {op} differs from plain")
        if f"bitwise[{op}]" in err:
            err[f"bitwise[{op}]"] = max_abs_err(got, exp)
    # meter_fold at a main-path shape: shift_k(1000)'s event tables folded
    # onto every slot of the full device
    prog = pim.shift_workload_program(1000, 512, w)
    f_tab, i_tab = pim.cost_tables(prog)
    f_tab = torch.from_numpy(np.array(f_tab)).to(device)
    i_tab = torch.from_numpy(np.array(i_tab)).to(device)
    rng = np.random.default_rng(4)
    f0 = torch.from_numpy((rng.random((n, 6)) * 1e5).astype(np.float32)
                          ).to(device)
    i0 = torch.from_numpy(rng.integers(0, 10**6, (n, 6)).astype(np.int32)
                          ).to(device)
    ff, fi = ops.meter_fold(f_tab, i_tab, f0, i0)
    ef, ei = ref.ref_meter_fold(f_tab, i_tab, f0, i0)
    if not (torch.equal(ff.cpu().view(torch.int32),
                        ef.cpu().view(torch.int32))
            and torch.equal(fi.cpu(), ei.cpu())):
        raise AssertionError("meter_fold differs from the numpy fold")
    err["meter_fold"] = max(max_abs_err(ff.cpu(), ef.cpu()),
                            max_abs_err(fi.cpu(), ei.cpu()))

    m, cols = f_tab.shape[0], f0.shape[1] + i0.shape[1]
    calls = {   # name: (kernel, plain version, one PyTorch call or None)
        "shift_cols": (lambda: ops.shift_cols(x, 999),
                       lambda: ref.ref_shift_cols(x, 999), None),
        "bitwise[maj]": (lambda: ops.bitwise(x, b, c, op="maj"),
                         lambda: ref.ref_bitwise(x, b, c, op="maj"), None),
        "bitwise[not]": (lambda: ops.bitwise(x, op="not"),
                         lambda: ref.ref_bitwise(x, op="not"),
                         lambda: torch.bitwise_not(x)),
        "meter_fold": (lambda: ops.meter_fold(f_tab, i_tab, f0, i0),
                       lambda: ref.ref_meter_fold(f_tab, i_tab, f0, i0),
                       None),
    }
    work = {   # name: (bytes moved, operations, shape)
        "shift_cols": (8 * n * w, 0, f"({n}, {w}) int32, k=999"),
        "bitwise[maj]": (4 * 4 * n * w, 0, f"3 x ({n}, {w}) int32"),
        "bitwise[not]": (2 * 4 * n * w, 0, f"({n}, {w}) int32"),
        "meter_fold": (4 * (m * cols + 2 * n * cols), m * n * cols,
                       f"({m}, 6+6) tables onto ({n}, 6+6)"),
    }
    rows = {}
    for name, (kernel, plain, library) in calls.items():
        nbytes, nops, shape = work[name]
        # The plain meter fold runs in numpy on the host: it cannot be
        # captured in a graph, so it is timed with events around the call.
        plain_us = (event_us(plain, torch) if name == "meter_fold"
                    else device_us(plain, torch))
        rows[name] = dict(
            ms=device_us(kernel, torch) / 1e3,
            call_ms=event_us(kernel, torch) / 1e3,
            plain_ms=plain_us / 1e3,
            library_ms=(None if library is None
                        else device_us(library, torch) / 1e3),
            bytes=nbytes, ops=nops, shape=shape)
    for name, r in rows.items():
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["ops"] / H100_F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["max_abs_err"] = err[name]
        say(f"kernel {name} {r['shape']}: kernel {r['ms'] * 1e3:.2f} us "
            f"({r['call_ms'] * 1e3:.2f} us per call with the host's launch), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']}")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: one subarray at full geometry through execute()
# ---------------------------------------------------------------------------

def subarray_programs(rows: int = 512, words: int = 2048):
    """(name, program, refresh) of the subarray phase."""
    import numpy as np
    from repro_torch.core import pim

    out = [(f"shift_workload({n})", pim.shift_workload_program(n, rows,
                                                                words), False)
           for n in (1, 50, 100, 512, 1000)]
    b = pim.ProgramBuilder(rows, words)
    row = np.random.default_rng(5).integers(0, 2**32, (words,),
                                            dtype=np.uint32)
    b.write_row(0, row).issue().shift_k(0, 1, 1000)
    b.read_row(1)
    out.append(("quickstart", b.build(), True))
    out.append(("ambit_xor", pim.ambit_xor_program(rows, words), False))
    return out


def subarray_state(torch, device, rows: int = 512, words: int = 2048):
    from repro_torch.core import pim
    bits = rows_from_seed(6, (rows, words), torch, device)
    return pim.reserve_control_rows(pim.SubarrayState(
        bits=bits, mig_top=torch.zeros(words, dtype=torch.int32,
                                       device=device),
        mig_bot=torch.zeros(words, dtype=torch.int32, device=device),
        dcc=torch.zeros(words, dtype=torch.int32, device=device),
        meter=pim.CostMeter.zeros(device)))


def states_equal(torch, a, b) -> bool:
    fields = ("bits", "mig_top", "mig_bot", "dcc")
    if not all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in fields):
        return False
    from repro_torch.core.pim.state import FLOAT_FIELDS, INT_FIELDS
    for f in FLOAT_FIELDS + INT_FIELDS:
        x, y = getattr(a.meter, f).cpu(), getattr(b.meter, f).cpu()
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def reads_equal(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu())
                                    for x, y in zip(a, b))


def run_subarray(torch, device, rows=512, words=2048):
    """Main-path runs of phase 3 on ``device``: name -> ExecResult."""
    from repro_torch.core import pim
    state = subarray_state(torch, device, rows, words)
    return {name: pim.execute(prog, state, refresh=refresh)
            for name, prog, refresh in subarray_programs(rows, words)}


def check_subarray(torch, device, results, rows=512, words=2048):
    from repro_torch.core import pim
    gpu_state = subarray_state(torch, device, rows, words)
    cpu_state = subarray_state(torch, "cpu", rows, words)
    for name, prog, refresh in subarray_programs(rows, words):
        got = results[name]
        eager, eager_reads = pim.run_program(gpu_state, prog)
        if refresh:
            eager.meter = pim.apply_refresh(eager.meter)
        cpu = pim.execute(prog, cpu_state, refresh=refresh)
        for what, st, rd in (("eager ISA on the card", eager, eager_reads),
                             ("execute on the CPU", cpu.state, cpu.reads)):
            if not (states_equal(torch, got.state, st)
                    and reads_equal(torch, got.reads, rd)):
                raise AssertionError(f"subarray {name}: execute on the card "
                                     f"differs from the {what}")


# ---------------------------------------------------------------------------
# Phase 4: the full device through schedule()
# ---------------------------------------------------------------------------

def device_steps(cfg):
    """Three steps of per-slot programs: (programs, flags)."""
    import numpy as np
    from repro_torch.core import pim

    R, W = cfg.num_rows, cfg.words

    def chain(src, dst, k):
        return pim.ProgramBuilder(R, W).issue().shift_k(src, dst, k).build()

    mixed = (pim.ProgramBuilder(R, W).issue().ambit_and(4, 5, 6)
             .ambit_or(6, 7, 8).ambit_not(8, 9).shift_k(9, 10, 7)
             .tra(11, 12, 13).dra(13, 14).build())
    steps = []
    for k, flags in enumerate(({}, {"async_host": True},
                               {"async_host": True, "refresh": True})):
        rng = np.random.default_rng(100 + k)
        host = pim.ProgramBuilder(R, W).issue()
        host.write_row(20, np.zeros(W, np.uint32)).shift_k(20, 21, 64)
        host.read_row(21)
        host = host.build()
        flat = []
        for slot in range(cfg.n_slots):
            kind = slot % 8
            if kind == 0:
                flat.append(chain(0, 1, 40 + k))
            elif kind == 1:
                flat.append(chain(2, 3, -100))
            elif kind == 2:
                flat.append(chain(1, 15, 300))
            elif kind == 3:
                flat.append(pim.ambit_xor_program(R, W, a=0, b=1, dst=2))
            elif kind == 4:        # same stream, per-slot HOSTW data
                flat.append(host.with_payloads([rng.integers(
                    0, 2**32, (W,), dtype=np.uint32)]))
            elif kind == 5:
                flat.append(pim.xor_reduce_program(R, W, [0, 1, 2], 3))
            elif kind == 6:
                flat.append(None)
            else:
                flat.append(mixed)
        nb = cfg.n_banks
        moves = [((b, 0, 1), ((b + 1) % nb, 1, 30)) for b in range(nb)]
        if k == 1:     # a dependent chain: a later copy reads an earlier one
            moves += [((0, 1, 30), (5, 0, 31)), ((5, 0, 31), (9, 1, 32))]
        steps.append((pim.gather_rows(cfg, moves, flat), flags))
    return steps


def device_start(torch, device, cfg):
    from repro_torch.core import pim
    dev = pim.make_device(cfg, device=device)
    dev.banks.bits[:, :-2] = rows_from_seed(
        7, (cfg.n_slots, cfg.num_rows - 2, cfg.words), torch, device)
    return dev


def run_device(torch, device, cfg, steps):
    from repro_torch.core import pim
    dev = device_start(torch, device, cfg)
    results = []
    for programs, flags in steps:
        r = pim.schedule(dev, programs, **flags)
        results.append(r)
        dev = r.state
    return results


def check_device(torch, gpu_results, cpu_results):
    for k, (g, c) in enumerate(zip(gpu_results, cpu_results)):
        if not states_equal(torch, g.state.banks, c.state.banks):
            raise AssertionError(f"device step {k}: state differs from CPU")
        for f in ("wall_ns", "energy_nj"):
            x, y = getattr(g, f).cpu(), getattr(c, f).cpu()
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise AssertionError(f"device step {k}: {f} {x} != {y}")
        for f in ("copy_ns", "copy_queue_ns", "copy_total_ns", "bus_ns",
                  "host_bytes", "channel_bus_ns", "host_overlap_ns"):
            if getattr(g, f) != getattr(c, f):
                raise AssertionError(f"device step {k}: {f} differs")
        gr, cr = g.reads, c.reads
        if len(gr) != len(cr) or any(
                len(a) != len(b) or any((x != y).any() for x, y in zip(a, b))
                for a, b in zip(gr, cr)):
            raise AssertionError(f"device step {k}: reads differ")
        if not (torch.isfinite(g.wall_ns) and float(g.wall_ns) > 0
                and float(g.energy_nj) > 0):
            raise AssertionError(f"device step {k}: bad wall/energy")


# ---------------------------------------------------------------------------

def device_share(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host-clock ms of the
    window, the card's summed kernel time in it, their ratio (the card's
    busy share; one stream, so kernels do not overlap) and the kernels that
    took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = []
    for e in prof.key_averages():
        # device-side entries only (kernels, copies): an operator's own
        # entry repeats the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            kernels.append((us / 1e3, e.key, e.count))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else 0.0,
            "top": [{"name": k[1][:80], "ms": k[0], "count": k[2]}
                    for k in kernels[:6]]}


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.core import pim
    from repro_torch.kernels import _build
    from repro_torch.kernels.rowops import ops

    device = torch.device("cuda")
    card = card_line()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # 1. build
    t0 = time.perf_counter()
    _build.load("rowops")
    build_s = time.perf_counter() - t0
    record["build_s"] = build_s
    record["ptxas"] = _build.BUILD_LOG.get("rowops", "")
    say(f"build rowops.cu: {build_s:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS.get('rowops', 0.0):.2f} s)")

    # 2. kernels against their plain versions
    kernel_rows = phase_kernels(torch, device)
    record["kernels"] = kernel_rows

    # 3-4. the main path, with the launch counts reset just before it and
    # read just after it
    cfg = pim.paper_device(32, subarrays=2)
    steps = device_steps(cfg)
    ops.reset_launches()
    sub_results = run_subarray(torch, device)
    dev_results = run_device(torch, device, cfg, steps)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    by_op = dict(ops.LAUNCHES_BY_OP)

    check_subarray(torch, device, sub_results)
    m1 = sub_results["shift_workload(1)"].state.meter
    t_exec = {}
    state = subarray_state(torch, device)
    for name, prog, refresh in subarray_programs():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pim.execute(prog, state, refresh=refresh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        t_exec[name] = statistics.median(times)
    record["execute_ms"] = t_exec
    say("subarray 512x2048: execute == eager ISA (card) == execute (CPU) "
        f"for {len(t_exec)} programs; shift x1 meter {float(m1.time_ns):.1f}"
        f" ns / {float(m1.total_energy_nj):.2f} nJ (DDR3 model output; "
        "paper 208.7 ns / 31.32 nJ); "
        "ms per execute on the card: "
        + ", ".join(f"{k} {v:.2f}" for k, v in t_exec.items()))

    cpu_results = run_device(torch, "cpu", cfg, steps)
    check_device(torch, dev_results, cpu_results)
    t_steps = []
    for _ in range(2):
        dev = device_start(torch, device, cfg)
        for programs, flags in steps:
            torch.cuda.synchronize()
            t = time.perf_counter()
            dev = pim.schedule(dev, programs, **flags).state
            torch.cuda.synchronize()
            t_steps.append((time.perf_counter() - t) * 1e3)
    t_steps = t_steps[len(steps):]            # the second, warm pass
    record["schedule_ms"] = t_steps
    record["device_steps"] = [
        {"wall_ns": float(r.wall_ns), "energy_nj": float(r.energy_nj),
         "copy_ns": r.copy_ns, "copy_queue_ns": r.copy_queue_ns,
         "bus_ns": r.bus_ns, "host_overlap_ns": r.host_overlap_ns}
        for r in dev_results]
    mib = dev_results[0].state.banks.bits.numel() * 4 / 2**20
    say(f"device paper_device(32, subarrays=2): {cfg.n_slots} slots, "
        f"{mib:.0f} MiB of rows on the card; 3 schedule() steps == CPU run "
        "(states, reads, wall_ns, energy_nj, copy and bus stats); "
        "ms per schedule() step on the card: "
        + ", ".join(f"{t:.2f}" for t in t_steps))

    # where the time goes: one warm execute and one warm schedule step
    start = device_start(torch, device, cfg)
    shares = {
        "execute(shift_workload(1000))": device_share(
            torch, lambda: pim.execute(pim.shift_workload_program(1000),
                                       state)),
        "schedule() step 1": device_share(
            torch, lambda: pim.schedule(start, steps[0][0], **steps[0][1])),
    }
    record["profile"] = shares
    for name, sh in shares.items():
        if sh["device_ms"] == 0.0:
            say(f"profile {name}: device time not measured (the profiler "
                "recorded no kernel time)")
            continue
        say(f"profile {name}: {sh['wall_ms']:.2f} ms on the host clock, "
            f"{sh['device_ms']:.3f} ms of kernels, busy share "
            f"{sh['busy_share']:.3f}; top: "
            + "; ".join(f"{k['name']} {k['ms']:.3f} ms x{k['count']}"
                        for k in sh["top"][:3]))

    # 5. launches over the main path
    say("kernels " + json.dumps({**launches, **{f"bitwise[{k}]": v
                                                for k, v in by_op.items()}}))
    main_path = {"shift_cols": launches["shift_cols"],
                 "bitwise[maj]": by_op["maj"], "bitwise[not]": by_op["not"],
                 "meter_fold": launches["meter_fold"]}
    missing = [k for k, v in main_path.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    table = []
    for name, r in kernel_rows.items():
        table.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name.split("[")[0]],
            "launches": main_path[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    record["table"] = table
    out = ROOT / "chiprun_out"
    try:
        out.mkdir(exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    except OSError as e:
        print(f"chip_smoke: could not write {out}: {e}", file=sys.stderr)
    say(json.dumps({"kernels": table}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
