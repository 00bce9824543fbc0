#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; exits non-zero, printing no result, without them. Phases, one line
each, every mismatch fatal:

1. build     — the three CUDA libraries (rowops, pim_matmul, flash_attn),
               one nvcc per source, all started together;
2. kernels   — each row kernel against its plain torch version on the
               card, bit for bit, at the executor's shapes; device times (a
               CUDA graph of 20 launches, replayed 20 times, median) beside
               the plain version's, the memory-rate bound and the time of
               one call with the host's launch (CUDA events, median of 20);
3. subarray  — recorded programs through ``execute()`` at the paper's
               512 x 2,048 geometry, held exactly against the port's eager
               ISA on the card and ``execute()`` on the CPU;
4. device    — ``schedule()`` on ``paper_device(32, subarrays=2)`` (64
               slots, 256 MiB of rows on the card): heterogeneous programs,
               host writes and reads, a cross-bank COPY drain, two async
               steps (the second also refreshed), held exactly against the
               CPU run;
5. launches  — kernel launches over the PIM path of phases 3-4 (counts
               reset just before, read just after); each kernel must run;
6. lm kernels — pim_matmul (M 4 and 512, K x N 2560 x 9728 and 9728 x
               2560, both modes, 4 and 8 bits) and flash_attn (Qwen3-4B's
               heads at prefill and decode) against their plain versions on
               the card, with device and per-call times, bound and the time
               of one PyTorch library call;
7. serve     — the LM serving path: ``greedy_generate`` on Qwen3-4B
               (pim_w4, shift_add) at full width and depth, weights from a
               seed, batch 4, prompt 128, 16 new tokens (launch counts reset
               just before, read just after, each kernel must run); ms of
               prefill and per decode token, GB on the card, decode against
               prefill, the busy share of one prefill and one decode step;
8. lm parity — the same model at 2 layers, on the card (kernels) and on the
               CPU (plain versions), logits compared step by step.

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
H100_BF16_OPS_PER_S = 989e12     # bf16 tensor cores, dense
SOURCES = {
    "rowops": "src/repro_torch/kernels/rowops/csrc/rowops.cu",
    "pim_matmul": "src/repro_torch/kernels/pim_matmul/csrc/pim_matmul.cu",
    "flash_attn": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
}
REPLACES = {
    "shift_cols": "src/repro/kernels/rowops/rowops.py:137",
    "bitwise": "src/repro/kernels/rowops/rowops.py:120",
    "meter_fold": "src/repro/core/pim/compile.py:247",
    "pim_matmul": "src/repro/kernels/pim_matmul/pim_matmul.py:61",
    "flash_attn": "src/repro/kernels/flash_attn/flash_attn.py:75",
}
# Tolerances of the LM phases. pim_matmul: the kernel and its plain version
# compute the same float32 function (exact products, sums over K <= 9,728
# in another order), so max |kernel - plain| <= 1e-4 of max |plain|.
# flash_attn: the reference tests' bounds, abs 0.05 for bf16 tensors (the
# outputs round to bf16 after float32 sums in another order) and 2e-5 for
# float32. The model's logits, card against CPU and decode against prefill:
# 2e-2 of max |logit|, the bound the port's CPU tests hold the bf16 model to
# against the reference (bf16 rounds in other places on either side).
PIM_REL = 1e-4
FLASH_BF16_ABS = 0.05
FLASH_F32_ABS = 2e-5
LOGITS_REL = 2e-2
LM_ARCH = ("qwen3-4b", {"quant": "pim_w4", "quant_mode": "shift_add"})
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 16
# (M, K, N) of the serving path's FFN linears at decode (M = batch) and at
# prefill (M = batch x prompt); the first is the table's row
PIM_SHAPES = ((4, 2560, 9728), (4, 9728, 2560), (512, 2560, 9728),
              (512, 9728, 2560))
# flash_attn at Qwen3-4B's heads: (B, KV, G, dh, Sq, Sk, first query
# position); at decode the slots after the query's position hold kpos -1
FLASH_SHAPES = {"prefill": (4, 8, 4, 128, 128, 128, 0),
                "decode": (4, 8, 4, 128, 1, 144, 135)}
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT, PARITY_NEW = 2, 2, 32, 4
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


# ---------------------------------------------------------------------------
# Phase 6: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def _kernel_row(torch, kernel, plain, library, nbytes, nops, shape, err,
                per_graph=5, reps=5):
    """Times of one kernel call (device and per call), its plain version and
    its library call, in ms, and its bound from ``nbytes`` and ``nops``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_BF16_OPS_PER_S * 1e3
    return dict(
        ms=device_us(kernel, torch, per_graph, reps) / 1e3,
        call_ms=event_us(kernel, torch, reps=reps) / 1e3,
        plain_ms=device_us(plain, torch, per_graph, reps) / 1e3,
        library_ms=device_us(library, torch, per_graph, reps) / 1e3,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, ops=nops, shape=shape, max_abs_err=err)


def _say_row(name, r):
    say(f"kernel {name} {r['shape']}: kernel {r['ms'] * 1e3:.2f} us "
        f"({r['call_ms'] * 1e3:.2f} us per call with the host's launch), "
        f"plain {r['plain_ms'] * 1e3:.2f} us, library "
        f"{r['library_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us "
        f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e}")


def phase_lm_kernels(torch, device):
    """pim_matmul and flash_attn at the serving path's shapes, each against
    its plain version on the same tensors; name -> row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.flash_attn import ref as fref
    from repro_torch.kernels.pim_matmul import ops as pm
    from repro_torch.kernels.pim_matmul import ref as pref

    gen = torch.Generator(device=device).manual_seed(11)
    rows = {}
    for m, k, n in PIM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=device).to(
            torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device)
        for bits in (4, 8):
            w_int, scales = pm.quantize(w, bits)
            w_deq = pref.ref_dequant(w_int, scales, bits).to(
                torch.bfloat16)
            for mode in ("shift_add", "dequant"):
                def kernel(x=x, w_int=w_int, scales=scales, mode=mode,
                           bits=bits):
                    return pm.pim_matmul(x, w_int, scales, mode=mode,
                                         bits=bits)

                def plain(x=x, w_int=w_int, scales=scales, mode=mode,
                          bits=bits):
                    return pref.ref_pim_matmul_raw(
                        x, w_int, mode=mode, bits=bits) * scales[None, :]

                got, exp = kernel(), plain()
                torch.cuda.synchronize()
                err = max_abs_err(got, exp)
                top = float(exp.abs().max())
                if not (torch.isfinite(got).all() and err <= PIM_REL * top):
                    raise AssertionError(
                        f"pim_matmul {mode} w{bits} ({m}, {k}, {n}): "
                        f"max abs err {err} > {PIM_REL} x {top}")
                name = f"pim_matmul[{mode},w{bits}] ({m},{k})@({k},{n})"
                rows[name] = _kernel_row(
                    torch, kernel, plain,
                    lambda x=x, w_deq=w_deq: torch.matmul(x, w_deq),
                    2 * m * k + k * n + 4 * n + 4 * m * n, 2 * m * k * n,
                    f"x ({m}, {k}) bf16, w ({k}, {n}) int{bits}", err)
                _say_row(name, rows[name])
                del got, exp
    for phase, (B, KV, G, dh, sq, sk, pq0) in FLASH_SHAPES.items():
        q = torch.randn((B, sq, KV, G, dh), generator=gen, device=device)
        k = torch.randn((B, sk, KV, dh), generator=gen, device=device)
        v = torch.randn((B, sk, KV, dh), generator=gen, device=device)
        pos_q = torch.arange(pq0, pq0 + sq, dtype=torch.int32, device=device)
        pos_k = torch.arange(sk, dtype=torch.int32, device=device).repeat(
            B, 1)
        if phase == "decode":        # slots not yet written: kpos = -1
            pos_k[:, pq0 + 1:] = -1
            v[:, pq0 + 1:] = 1e4     # and poisoned: they must weigh 0
        for dt, bound in ((torch.float32, FLASH_F32_ABS),
                          (torch.bfloat16, FLASH_BF16_ABS)):
            got = fa.flash_attention(q.to(dt), k.to(dt), v.to(dt), pos_q,
                                     pos_k)
            exp = fref.ref_flash_attention(q.to(dt), k.to(dt), v.to(dt),
                                           pos_q, pos_k)
            torch.cuda.synchronize()
            err = max_abs_err(got.float(), exp.float())
            if not (torch.isfinite(got.float()).all() and err < bound):
                raise AssertionError(f"flash_attn {phase} {dt}: max abs err "
                                     f"{err} >= {bound}")
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        qt = qb.reshape(B, sq, KV * G, dh).transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kb, vb))
        seen = ((pos_k[:, None, :] >= 0)
                & (pos_k[:, None, :] <= pos_q[None, :, None]))  # (B, Sq, Sk)
        mask = seen[:, None]
        pairs = int(seen.sum())
        name = f"flash_attn[{phase}]"
        rows[name] = _kernel_row(
            torch,
            lambda: fa.flash_attention(qb, kb, vb, pos_q, pos_k),
            lambda: fref.ref_flash_attention(qb, kb, vb, pos_q, pos_k),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            2 * (2 * qb.numel() + kb.numel() + vb.numel())
            + 4 * (pos_q.numel() + pos_k.numel()),
            4 * dh * KV * G * pairs,
            f"q ({B}, {sq}, {KV}, {G}, {dh}), k/v ({B}, {sk}, {KV}, {dh}) "
            f"bf16, {pairs} seen (query, key) pairs", err, per_graph=10,
            reps=10)
        _say_row(name, rows[name])
    return rows


# ---------------------------------------------------------------------------
# Phases 7-8: the LM serving path
# ---------------------------------------------------------------------------

def lm_config(**overrides):
    from repro_torch.configs import get_config
    arch, quant = LM_ARCH
    return get_config(arch, **quant, **overrides)


def prompt_tokens(torch, seed, batch, length, vocab, device):
    import numpy as np
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, vocab, (batch, length)), dtype=torch.int32, device=device)


def rel_err(torch, a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def teacher_forced(cfg, model, prompt, tokens, device):
    """Prefill logits, then one decode step per generated token but the
    last, fed ``tokens``: a list of (B, 1, V) float32 logits."""
    from repro_torch.models import decode_step, prefill
    s, n = prompt.shape[1], tokens.shape[1]
    logits, caches = prefill(cfg, model, {"tokens": prompt}, s + n,
                             device=device)
    out = [logits]
    for t in range(n - 1):
        logits, caches = decode_step(cfg, model,
                                     {"tokens": tokens[:, t:t + 1]}, s + t,
                                     caches, device=device)
        out.append(logits)
    return out


def run_serve(torch, device):
    """The serving path at full width and depth. Returns (record, launches
    over the ``greedy_generate`` run)."""
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.pim_matmul import ops as pm
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve.engine import greedy_generate

    cfg = lm_config()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model = init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights_gb = (torch.cuda.memory_allocated() - base) / 1e9
    prompt = prompt_tokens(torch, 12, SERVE_BATCH, SERVE_PROMPT,
                           cfg.vocab_size, device)
    batch = {"tokens": prompt}
    torch.cuda.reset_peak_memory_stats()

    pm.reset_launches()
    fa.reset_launches()
    t = time.perf_counter()
    out = greedy_generate(cfg, model, batch, max_new_tokens=SERVE_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = {"pim_matmul": pm.LAUNCHES["pim_matmul"],
                "flash_attn": fa.LAUNCHES["flash_attn"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L, V = cfg.n_layers, cfg.vocab_size
    if tuple(out.shape) != (SERVE_BATCH, SERVE_NEW) \
            or out.dtype != torch.int32 or int(out.min()) < 0 \
            or int(out.max()) >= V:
        raise AssertionError(f"greedy_generate gave {tuple(out.shape)} "
                             f"{out.dtype} tokens in [{int(out.min())}, "
                             f"{int(out.max())}]")
    expected = {"pim_matmul": 3 * L * SERVE_NEW, "flash_attn": L * SERVE_NEW}
    if launches != expected:
        raise AssertionError(f"serving launches {launches}, expected "
                             f"{expected}")

    max_len = SERVE_PROMPT + SERVE_NEW
    logits, _ = prefill(cfg, model, batch, max_len)
    if not (torch.isfinite(logits).all()
            and torch.equal(out[:, 0], torch.argmax(logits[:, 0], -1).int())):
        raise AssertionError("the first generated token is not the argmax "
                             "of the prefill logits")
    _, caches = prefill(cfg, model, {"tokens": prompt[:, :-1]}, max_len)
    dec, _ = decode_step(cfg, model, {"tokens": prompt[:, -1:]},
                         SERVE_PROMPT - 1, caches)
    dvp = rel_err(torch, dec, logits)
    if not dvp < LOGITS_REL:
        raise AssertionError(f"decode vs prefill logits: rel {dvp} >= "
                             f"{LOGITS_REL}")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    prefill_ms = statistics.median(
        timed(lambda: prefill(cfg, model, batch, max_len)) for _ in range(3))
    per_token = []
    for _ in range(2):
        _, caches = prefill(cfg, model, batch, max_len)

        def steps(caches=caches):
            for t in range(SERVE_NEW - 1):
                decode_step(cfg, model, {"tokens": out[:, t:t + 1]},
                            SERVE_PROMPT + t, caches)

        per_token.append(timed(steps) / (SERVE_NEW - 1))
    decode_ms = statistics.median(per_token)
    generate_ms = timed(lambda: greedy_generate(
        cfg, model, batch, max_new_tokens=SERVE_NEW))

    _, caches = prefill(cfg, model, batch, max_len)
    shares = {
        "prefill": device_share(torch, lambda: prefill(cfg, model, batch,
                                                       max_len)),
        "decode step": device_share(torch, lambda: decode_step(
            cfg, model, {"tokens": out[:, :1]}, SERVE_PROMPT, caches)),
    }
    record = dict(
        config=dict(arch=cfg.arch_id, quant=cfg.quant,
                    quant_mode=cfg.quant_mode, n_layers=L,
                    d_model=cfg.d_model, vocab=V, batch=SERVE_BATCH,
                    prompt=SERVE_PROMPT, new_tokens=SERVE_NEW),
        init_s=init_s, first_generate_s=first_s, weights_gb=weights_gb,
        peak_gb=peak_gb, prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
        generate_ms=generate_ms, decode_vs_prefill_rel=dvp,
        tokens=out.cpu().tolist(), profile=shares)
    say(f"serve {cfg.arch_id} {cfg.quant} {cfg.quant_mode} ({L} layers, "
        f"d_model {cfg.d_model}): batch {SERVE_BATCH}, prompt "
        f"{SERVE_PROMPT}, {SERVE_NEW} new tokens; prefill {prefill_ms:.2f} "
        f"ms, decode {decode_ms:.2f} ms per token, greedy_generate "
        f"{generate_ms:.2f} ms; {weights_gb:.2f} GB of weights on the card, "
        f"peak {peak_gb:.2f} GB; decode vs prefill logits rel {dvp:.3e} "
        f"(bound {LOGITS_REL}); launches {json.dumps(launches)}")
    for name, sh in shares.items():
        say_share(f"serve {name}", sh)
    del model, caches
    torch.cuda.empty_cache()
    return record, launches


def run_lm_parity(torch, device):
    """Full width, PARITY_LAYERS layers: greedy_generate on the card, then
    the same weights and tokens teacher-forced on the card and on the
    CPU."""
    from repro_torch.models import init_params
    from repro_torch.serve.engine import greedy_generate

    cfg = lm_config(n_layers=PARITY_LAYERS)
    model = init_params(cfg, 1, device=device)
    prompt = prompt_tokens(torch, 13, PARITY_BATCH, PARITY_PROMPT,
                           cfg.vocab_size, device)
    toks = greedy_generate(cfg, model, {"tokens": prompt},
                           max_new_tokens=PARITY_NEW)
    card = [lg.cpu() for lg in teacher_forced(cfg, model, prompt, toks,
                                              device)]
    if not torch.equal(toks[:, 0].cpu(), torch.argmax(card[0][:, 0], -1)
                       .int()):
        raise AssertionError("lm parity: first token is not the argmax")
    model.to("cpu")
    t = time.perf_counter()
    cpu = teacher_forced(cfg, model, prompt.cpu(), toks.cpu(), "cpu")
    cpu_s = time.perf_counter() - t
    rels = [rel_err(torch, a, b) for a, b in zip(card, cpu)]
    if not all(torch.isfinite(a).all() for a in card) \
            or max(rels) >= LOGITS_REL:
        raise AssertionError(f"lm parity: card vs CPU logits rel {rels} "
                             f"(bound {LOGITS_REL})")
    say(f"lm parity {cfg.arch_id} {cfg.quant} {cfg.quant_mode} at full "
        f"width, {PARITY_LAYERS} layers, batch {PARITY_BATCH}, prompt "
        f"{PARITY_PROMPT}, {PARITY_NEW} tokens: card (kernels) vs CPU (plain "
        f"versions) logits rel per step "
        + ", ".join(f"{r:.3e}" for r in rels)
        + f" (bound {LOGITS_REL}); CPU run {cpu_s:.1f} s")
    return {"rel_per_step": rels, "cpu_s": cpu_s,
            "tokens": toks.cpu().tolist()}


def say_share(name: str, sh: dict) -> None:
    if sh["device_ms"] == 0.0:
        say(f"profile {name}: device time not measured (the profiler "
            "recorded no kernel time)")
        return
    say(f"profile {name}: {sh['wall_ms']:.2f} ms on the host clock, "
        f"{sh['device_ms']:.3f} ms of kernels, busy share "
        f"{sh['busy_share']:.3f}; top: "
        + "; ".join(f"{k['name']} {k['ms']:.3f} ms x{k['count']}"
                    for k in sh["top"][:3]))


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

    # 1. build: one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    record["build_s"] = build_s
    record["ptxas"] = {name: _build.BUILD_LOG.get(name, "")
                       for name in SOURCES}
    for name, src in SOURCES.items():
        say(f"build {Path(src).name}: {build_s:.2f} s for all "
            f"{len(SOURCES)} in parallel (nvcc "
            f"{_build.BUILD_SECONDS.get(name, 0.0):.2f} s)")

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
        say_share(name, sh)

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

    # 6. the LM kernels against their plain versions
    lm_rows = phase_lm_kernels(torch, device)
    record["lm_kernels"] = lm_rows

    # 7. the serving path, with the launch counts reset just before it and
    # read just after it (inside run_serve)
    record["serve"], lm_launches = run_serve(torch, device)
    say("kernels serve " + json.dumps(lm_launches))

    # 8. card against CPU at full width, 2 layers
    record["lm_parity"] = run_lm_parity(torch, device)

    table = []
    for name, r in kernel_rows.items():
        table.append({
            "name": name, "route": "cuda", "source": SOURCES["rowops"],
            "replaces": REPLACES[name.split("[")[0]],
            "launches": main_path[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # one row per LM kernel, at the shape that runs most often on the
    # serving path (a decode step); every shape is in chip_smoke.json
    m, k, n = PIM_SHAPES[0]
    for kernel, row in (("pim_matmul",
                         f"pim_matmul[shift_add,w4] ({m},{k})@({k},{n})"),
                        ("flash_attn", "flash_attn[decode]")):
        r = lm_rows[row]
        table.append({
            "name": row, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": lm_launches[kernel],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
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
