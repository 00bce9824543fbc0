#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; exits non-zero, printing no result, without them. Phases, one line
each, every mismatch fatal:

1. build     — the three CUDA libraries (rowops, pim_matmul, flash_attn),
               one nvcc per source, all started together;
2. kernels   — the latency of one dependent float32 add (one thread, a
               chain of 2^20 ``__fadd_rn``: SM cycles from clock64 and ns
               from CUDA events), which bounds ``meter_fold``; then each row
               kernel against its plain torch version on the card, bit for
               bit, at the executor's shapes; device times (a CUDA graph of
               20 launches, replayed 20 times, median) beside the plain
               version's, the bound (``meter_fold``: its m adds in order at
               that latency) and the time of one call with the host's
               launch (CUDA events, median of 20); then the executor's row
               entries, ``bitwise_rows`` and ``shift_rows``, on (1 and
               64, 16, 2,048) slot states: bit for bit against their plain
               versions at every alias (a destination that is a source, a
               shift in place) and shift length, one launch per call, and
               each segment timed in place and out of place beside the old
               lowering of the same segment (the out-of-place kernel plus
               its gathers, copies and glue, in one CUDA graph);
3. subarray  — recorded programs through ``execute()`` at the paper's
               512 x 2,048 geometry, held exactly against the port's eager
               ISA on the card and ``execute()`` on the CPU;
4. device    — ``schedule()`` on ``paper_device(32, subarrays=2)`` (64
               slots, 256 MiB of rows on the card): heterogeneous programs,
               host writes and reads, a cross-bank COPY drain, two async
               steps (the second also refreshed), held exactly against the
               CPU run;
5. launches  — kernel launches over the PIM path of phases 3-4 (counts
               reset just before, read just after); each kernel must run,
               the old out-of-place entries not at all; then the card's
               operations per run in the profiler window (execute() of
               shift_workload(1000) and ambit_xor, one schedule() step,
               each phase-10 routine), the row entries' launches held to
               one per fused segment and residual SHIFT/TRA/NOT row of the
               programs run, beside the torch ops the executor dispatched
               before the row entries (printed after phase 10; the three
               routines that have that count must halve it);
6. lm kernels — pim_matmul (M 4 and 512, K x N 2560 x 9728 and 9728 x
               2560, both modes, 4 and 8 bits; each row names the route,
               ``swap_ab`` at M 4 and ``tensor_core`` at M 512, that
               ``ops.route`` gives it; the M 4 rows cycle over four weight
               copies, 100 MB, so each call finds its weights outside the
               50 MB L2 as a decode step does, and also time the
               ``cuda_core`` route) and flash_attn (each row names its route,
               ``tensor_core``, ``tiled`` or ``split_kv``: Qwen3-4B's heads
               at prefill and decode, that decode over 8,192 slots, MLA's
               decode at dk 576 / dv 512, recurrentgemma-2b's decode on a
               2,048-slot ring under its window, MLA's prefill at dk 192 /
               dv 128, Qwen3-4B's heads at a 2,048-token prompt) against
               their plain versions on the card (flash in float32, on the
               tiled route, and bf16), with device and per-call times,
               bound and the time of one PyTorch library call (the
               tensor-core rows also time the tiled route); then the three
               pim_matmul routes at M 4, 8, 16 and 64 (``swap_ab`` up to
               16) and the three flash routes at 4 to 256 rows per pair
               (the route thresholds), the tensor-core kernel's K splits at
               M 512, the swapped kernel's at M 4 and the flash split
               route's key splits at its decode shapes, each timed; the
               ``ptxas`` report (registers, shared memory, spills) of the
               pim_matmul tensor-core kernels and of flash's (the run fails
               if a swapped instance or flash's tensor-core instance at 128
               / 128, 192 / 128 or 256 / 256 spills), and the ``HMMA``
               count (``cuobjdump -sass``) of every tensor-core kernel,
               which must be above 0 in every instance, with the swapped
               kernel's integer instructions per weight code;
7. serve     — the LM serving path: ``greedy_generate`` on Qwen3-4B
               (pim_w4, shift_add) at full width and depth, weights from a
               seed, batch 4, prompt 128, 16 new tokens, each call one
               CUDA-graph replay: the first call (warm-up, capture, replay)
               timed apart from the replayed calls (median of 3) and the
               graph alone (CUDA events); launch counts and DECODE_STATS
               reset just before a replayed call and read just after it
               (1,728 pim_matmul and 576 flash_attn launches, prefill's
               108 pim_matmul calls on the tensor cores and decode's 1,620
               on the swapped operands, none on the CUDA cores, prefill's
               36 flash_attn calls on the tensor cores and decode's 540
               split over the keys; one dispatch, none for zero tokens;
               the first call adds its warm-up's eager prefill and decode
               step); every token the argmax of the eager loop's logits,
               teacher-forced on the card's tokens, bit for bit; one
               ``cudaGraphLaunch`` and no kernel launch per replayed call
               in the profiler; the graph pool's bytes; beside them the
               eager ms of prefill, per decode token and of the whole loop,
               GB on the card, decode against prefill, the busy share of a
               replayed call, one prefill and one decode step, and the
               kernel ms of prefill and of a decode step with pim_matmul's
               and flash's shares; the memory left once the model and its
               graphs are freed;
8. lm parity — the same model at 2 layers: greedy_generate on the card (one
               replay, its tokens the card's argmax chain), logits
               teacher-forced on the card (kernels) and on the CPU (plain
               versions) compared step by step, and the CPU's eager
               greedy_generate, whose tokens must equal the card's wherever
               the card's top-2 margin exceeds twice the bound;
9. ripple    — ``ripple_add`` against its plain version at (512, 2,048) for
               every width dividing 32 and at ragged shapes, bit for bit,
               with device times, the plain version's, the bound and one
               library call where one computes the same function
               (``torch.bitwise_xor`` at w 1, ``torch.add`` on the rows
               viewed as uint8/int16/int32 at w 8/16/32); then the kernel
               bench's path, ripple_add's own (launch counts reset just
               before, read just after, ripple_add must run): the fused
               adder against the 30-launch composition of
               ``bitwise``/``shift_cols`` at w 8;
10. bitplane — the bit-plane layer at the crypto case study's full-row
               sizes (launch counts reset just before, read just after,
               each kernel must run; the VM records PIM commands and never
               calls ripple_add): ``PimVM`` routines on 8 KB rows, each
               equal to its numpy oracle, and the fused adder on the VM's
               own operand rows equal to ``add_ripple`` (that launch
               counted apart); RS(12,8) on 32
               banks of full rows equal to the oracle and to one wide
               subarray; the async pipeline's identities (equal bits and
               energy, sync wall - async wall = hidden host time); one
               ``run_pipeline`` and one ``run_workload`` equal to the same
               steps flushed one by one;
11. bitplane parity — phase 10 again on the CPU: reads, counts and every
               float32 meter identical;
12. fold sweep — ``meter_fold`` at m = 64, 4,001 and the largest table the
               card's PIM and bit-plane runs of phases 3-4 and 10 folded,
               each onto 1 and 64 slots: bit for bit against its plain
               version, device time beside the chain bound;
13. gates    — ``execute()`` (phase 3's programs), ``schedule()`` (phase
               4's steps) and ``schedule_pipeline()`` with ``verify=True``
               bit for bit against ``verify=False`` on the card; the pim104
               lint fixture refused (LintError, PIM104) at its own 16 x 2
               geometry and moved to the paper's; the static tools' host ms
               per program, cold, and on the reference tests' 100k-op
               streams;
14. front    — ``PimServeFront`` on ``paper_device(32, subarrays=2)``:
               eight tenants of four banks, 16 steps each (six on
               ``benchmarks/serve_bench.py``'s stream, write a row, a 40-hop
               shift chain, read back; two on ``ambit_xor_program`` after
               host writes), each slot's data private and seeded; a ninth
               tenant (pim104 at full width) refused by the admission lint,
               a tenth refused as over-subscribing; each tenant's reads,
               slot states, float32 meters and busy/energy equal to its own
               ``schedule()`` on a private slice of the card, and the whole
               front equal to the same front on the CPU (reads, states,
               reports, ``reconcile()``); steps/s cold and warm, dispatches
               per step, coalescing, p50/p99 step ``wall_ns``, admission
               lint ms, a ``profile front`` line and ``kernels front``
               (launch counts reset just before the measured run, read just
               after; each row entry and ``meter_fold`` must run);
15. tables   — ``shift_failure_rate`` on the card at 0, 5, 10 and 20 %
               variation, 100,000 trials, within the reference test's bounds
               of the paper's Table 4; the area model's Table 5.

Then the kernel table as JSON, the card's name and power limit, and the
result line. Nanoseconds and nanojoules of the DDR3 meter are outputs of
the simulated DRAM's model; milliseconds and microseconds are times of the
card. Everything measured is also written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import importlib
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
# int32 integer and logic instructions outside the tensor cores: 64 INT32
# lanes per SM (Hopper architecture white paper) x 132 SMs x 1.98 GHz boost
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
SOURCES = {
    "rowops": "src/repro_torch/kernels/rowops/csrc/rowops.cu",
    "pim_matmul": "src/repro_torch/kernels/pim_matmul/csrc/pim_matmul.cu",
    "flash_attn": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
}
REPLACES = {
    "shift_cols": "src/repro/kernels/rowops/rowops.py:137",
    "shift_rows": "src/repro/kernels/rowops/rowops.py:137",
    "bitwise": "src/repro/kernels/rowops/rowops.py:120",
    "bitwise_rows": "src/repro/kernels/rowops/rowops.py:120",
    "meter_fold": "src/repro/core/pim/compile.py:247",
    "pim_matmul": "src/repro/kernels/pim_matmul/pim_matmul.py:61",
    "flash_attn": "src/repro/kernels/flash_attn/flash_attn.py:75",
    "ripple_add": "src/repro/kernels/rowops/rowops.py:151",
}
# Tolerances of the LM phases. pim_matmul: the kernel and its plain version
# compute the same float32 function (exact products, sums over K <= 9,728
# in another order), so max |kernel - plain| <= 1e-4 of max |plain|.
# flash_attn: abs 2e-5 for float32 (the reference tests' bound; float32
# stays on the CUDA cores' float32 products, the tiled and split routes);
# for bf16 tensors 1e-2 of max |plain|: both sides take the same bf16
# inputs, sum in float32 and round the output to bf16, so they differ by
# at most about one bf16 ulp of the largest output, which is at most 2^-7
# of it; the tensor-core route also rounds each softmax weight p to bf16
# before P V, a relative error of at most 2^-9 per weight, so an output
# moves by at most 2^-9 times max |v| (sum p |v| / sum p), and by far less
# as the weights' rounding errors differ in sign. The model's logits, card
# against CPU and decode against prefill: 2e-2 of max |logit|, the bound
# the port's CPU tests hold the bf16 model to against the reference (bf16
# rounds in other places on either side).
PIM_REL = 1e-4
FLASH_BF16_REL = 1e-2
FLASH_F32_ABS = 2e-5
LOGITS_REL = 2e-2
LM_ARCH = ("qwen3-4b", {"quant": "pim_w4", "quant_mode": "shift_add"})
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 16
# (M, K, N) of the serving path's FFN linears at decode (M = batch) and at
# prefill (M = batch x prompt); the first is the table's row
PIM_SHAPES = ((4, 2560, 9728), (4, 9728, 2560), (512, 2560, 9728),
              (512, 9728, 2560))
# decode-sized calls are timed over this many copies of their weights,
# cycled (4 x 25 MB of int8 codes, beyond the 50 MB L2), as a decode step
# reads 108 different weights
WEIGHT_COPIES = 4
# flash_attn: (B, KV, G, dk, dv, Sq, Sk, last query position, window,
# ring). Qwen3-4B's heads at prefill and at decode (the slots after the
# query's position hold kpos -1 and poisoned values), the same decode over
# an 8,192-slot cache, MLA's decode (deepseek-v2-lite: one 576-wide latent
# key head, 512-wide values, 16 query heads), recurrentgemma-2b's decode
# (one kv head of 256, 10 query heads, a 2,048-slot ring under its 2,048
# window, positions unsorted), MLA's prefill (16 heads, dk 192, dv 128)
# and Qwen3-4B's heads at a 2,048-token causal prompt (batch 1)
FLASH_SHAPES = {
    "prefill": (4, 8, 4, 128, 128, 128, 128, 127, None, False),
    "decode": (4, 8, 4, 128, 128, 1, 144, 135, None, False),
    "decode,8k": (4, 8, 4, 128, 128, 1, 8192, 8183, None, False),
    "decode,mla": (4, 1, 16, 576, 512, 1, 2048, 2040, None, False),
    "decode,recurrentgemma": (4, 1, 10, 256, 256, 1, 2048, 5000, 2048, True),
    "prefill,mla": (4, 16, 1, 192, 128, 128, 128, 127, None, False),
    "prefill,2k": (1, 8, 4, 128, 128, 2048, 2048, 2047, None, False),
}
# the three flash routes at these query positions per pair (G = 4: 4 to
# 256 rows) over these key slots: the route threshold
FLASH_ROUTES = ("split_kv", "tensor_core", "tiled")
FLASH_THRESHOLD_SQ = (1, 4, 16, 32, 64)
FLASH_THRESHOLD_SK = (144, 8192)
# the split route's key split counts timed at each decode shape, beside
# the one its cost rule picks
FLASH_SPLITS = (1, 2, 4, 8, 16, 32, 64)
# the pim_matmul routes at these M, at (M, 2560) @ (2560, 9728), w4
# (swap_ab below TC_MIN_M); the tensor-core kernel's K splits timed at
# the two prefill shapes, the swapped kernel's at the two decode shapes
THRESHOLD_MS = (4, 8, 16, 64)
PIM_ROUTES = ("tensor_core", "swap_ab", "cuda_core")
TC_SPLITS = (1, 2, 3)
SWAP_SPLITS = (1, 2, 3, 4, 6, 8, 13, 16, 24, 32)
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT, PARITY_NEW = 2, 2, 32, 4
SHIFT_KS = (1, -1, 31, 32, 33, -33, 999, -999, 65535, 65536, 70000)
# phase 2b: the row entries on (B, 16, 2,048) states, B = 1 and 64 (one
# subarray; the full device's slots); shift chains of these many hops (and
# 32·W, 32·W + 1), both ways
ROW_SHAPE = (16, 2048)
ROW_SLOTS = (1, 64)
ROW_KS = (1, 2, 5, 31, 32, 33, 40, 999, 1000)
# torch ops the executor dispatched per run before the row entries (commit
# edcfc58), counted on the CPU with each kernel wrapper as one (views and
# copies included): the "before" of the launch counts; the routines run on
# PimVM(width=8), one bank. The three routines must fall to at most half.
BEFORE_OPS = {"execute(shift_workload(1000))": 21, "mul_shift_add": 5112,
              "gf_mul": 4849, "add_ripple": 329}
# Phases 9-11: ripple_add at the kernel bench's row block and ragged shapes;
# the bit-plane layer at the crypto case study's sizes (8 KB rows: 2,048
# words, 8,192 byte lanes)
RIPPLE_SHAPE = (512, 2048)
RIPPLE_PAIRS = 8
RIPPLE_RAGGED = ((37, 2048), (5, 33))
# meter_fold's bound: a dependent chain of this many adds in one thread
FADD_CHAIN = 1 << 20
# phase 12: tables of these many rows (and the largest the paths fold),
# folded onto this many slots
FOLD_ROWS = (64, 4001)
FOLD_SLOTS = (1, 64)
WIDTHS = (1, 2, 4, 8, 16, 32)
VM_WORDS, VM_ROWS = 2048, 64
VM_ROUTINES = ("add_ripple", "add_kogge_stone", "mul_shift_add", "xtime",
               "gf_mul", "mixcolumns")
RS_BANKS, RS_WORDS, RS_ROWS, RS_K, RS_NPAR = 32, 65536, 120, 8, 4
PIPE_BANKS, PIPE_WORDS, PIPE_CHUNKS = 8, 2048, 4
OPS = ("not", "and", "or", "xor", "maj")
# Phases 13-15: the static verifier's gates, the serving front end, and the
# paper's Tables 4 and 5.
LINT_FIXTURE = ROOT / "tests" / "fixtures" / "lint" / "pim104.trace"
LINT_100K = 100_000
FRONT_TENANTS = 8            # six on the serving bench's stream, two on XOR
FRONT_STREAM_TENANTS = 6
FRONT_BANKS = 4              # banks per tenant: 8 x 4 = the device's 32
FRONT_STEPS = 16
FRONT_SHIFT = 40             # benchmarks/serve_bench.py's chain
# variation % -> (paper Table 4, the reference test's absolute bound)
TABLE4 = {0.0: (0.0, 0.0), 5.0: (0.005, 0.004), 10.0: (0.14, 0.04),
          20.0: (0.30, 0.06)}
TABLE4_TRIALS = 100_000


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

def fadd_latency(torch, device) -> dict:
    """The latency of one dependent float32 add on the card: one thread
    adds FADD_CHAIN times in a ``__fadd_rn`` chain (``fadd_chain_kernel``
    in rowops.cu). SM cycles per add from clock64 inside the kernel; ns per
    add from CUDA events around the launch."""
    from repro_torch.kernels.rowops import ops
    lib = ops._lib()
    x = torch.tensor([1.0, 2.0**-30], device=device)
    out = torch.empty(1, device=device)
    cycles = torch.empty(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        rc = lib.rowops_fadd_chain(x.data_ptr(), out.data_ptr(),
                                   cycles.data_ptr(), FADD_CHAIN, stream)
        if rc:
            raise RuntimeError(f"fadd_chain launch failed: CUDA error {rc}")

    us = event_us(run, torch, reps=5, warmup=1)
    r = dict(adds=FADD_CHAIN, cycles_per_add=int(cycles.item()) / FADD_CHAIN,
             ns_per_add=us * 1e3 / FADD_CHAIN)
    say(f"fadd chain: {FADD_CHAIN} dependent __fadd_rn adds in one thread: "
        f"{r['cycles_per_add']:.3f} SM cycles per add (clock64), "
        f"{r['ns_per_add']:.4f} ns per add (CUDA events)")
    return r


def fold_bound_ms(m: int, nbytes: int, fadd: dict):
    """meter_fold's bound, in ms, and what sets it: each float (slot,
    field) adds its m increments in table order, so the chains take m
    dependent adds at the measured latency however many run beside each
    other; the bytes (each table and meter read once, written once) at
    the memory rate where they take longer."""
    t_chain = m * fadd["ns_per_add"] * 1e-6
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_chain, t_bytes), ("operations" if t_chain >= t_bytes
                                   else "bytes")


def phase_kernels(torch, device, fadd, n: int = 64, w: int = 2048):
    import numpy as np
    from repro_torch.kernels.rowops import ops, ref

    x = rows_from_seed(1, (n, w), torch, device)
    b = rows_from_seed(2, (n, w), torch, device)
    c = rows_from_seed(3, (n, w), torch, device)
    x_cpu = x.cpu()
    err = {"shift_cols": 0, "bitwise[maj]": 0, "bitwise[not]": 0,
           "bitwise[and]": 0, "bitwise[xor]": 0, "meter_fold": 0}
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
    f_tab, i_tab = fold_tables_of(torch, device)
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
        "bitwise[and]": (lambda: ops.bitwise(x, b, op="and"),
                         lambda: ref.ref_bitwise(x, b, op="and"),
                         lambda: torch.bitwise_and(x, b)),
        "bitwise[xor]": (lambda: ops.bitwise(x, b, op="xor"),
                         lambda: ref.ref_bitwise(x, b, op="xor"),
                         lambda: torch.bitwise_xor(x, b)),
        "meter_fold": (lambda: ops.meter_fold(f_tab, i_tab, f0, i0),
                       lambda: ref.ref_meter_fold(f_tab, i_tab, f0, i0),
                       None),
    }
    work = {   # name: (bytes moved, operations, shape)
        "shift_cols": (8 * n * w, 0, f"({n}, {w}) int32, k=999"),
        "bitwise[maj]": (4 * 4 * n * w, 0, f"3 x ({n}, {w}) int32"),
        "bitwise[not]": (2 * 4 * n * w, 0, f"({n}, {w}) int32"),
        "bitwise[and]": (3 * 4 * n * w, 0, f"2 x ({n}, {w}) int32"),
        "bitwise[xor]": (3 * 4 * n * w, 0, f"2 x ({n}, {w}) int32"),
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
        beside = ""
        if name == "meter_fold":
            # the adds at the float32 rate would take t_ops; their order
            # makes them a chain, which takes m add latencies
            r["throughput_bound_ms"] = r["bound_ms"]
            r["bound_ms"], r["bound_by"] = fold_bound_ms(m, r["bytes"], fadd)
            beside = (f" = {m} adds x {fadd['ns_per_add']:.4f} ns; the adds "
                      f"at the float32 rate {t_ops * 1e3:.3f} us")
        say(f"kernel {name} {r['shape']}: kernel {r['ms'] * 1e3:.2f} us "
            f"({r['call_ms'] * 1e3:.2f} us per call with the host's launch), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}{beside}), "
            f"max_abs_err {r['max_abs_err']}")
    return rows


# ---------------------------------------------------------------------------
# Phase 2b: the executor's row entries against their plain versions, beside
# the lowering they replace
# ---------------------------------------------------------------------------

def old_lowering(torch, ops, bits, seg, rows, delta=1, k=1000):
    """One segment as the executor lowered it before the row entries: the
    out-of-place kernel on gathered source rows, then the glue (row copies;
    for a shift chain the migration masks and the last hop in torch ops)."""
    from repro_torch.core.pim.isa import lsr
    from repro_torch.core.pim.state import EVEN_MASK, ODD_MASK

    def shift1(row):
        zero = torch.zeros(row.shape[:-1] + (1,), dtype=row.dtype,
                           device=row.device)
        if delta > 0:
            return (row << 1) | lsr(torch.cat([zero, row[..., :-1]], -1), 31)
        return lsr(row, 1) | (torch.cat([row[..., 1:], zero], -1) << 31)

    if seg == "maj":
        (a, b, c), dsts = rows
        m = ops.bitwise(bits[:, a].contiguous(), bits[:, b].contiguous(),
                        bits[:, c].contiguous(), op="maj")
        for r in dsts:
            bits[:, r] = m
        return None
    if seg == "not":
        (src,), (dst,) = rows
        dcc = ops.bitwise(bits[:, src].contiguous(), op="not")
        bits[:, dst] = dcc
        return dcc
    src, dst = rows
    y = ops.shift_cols(bits[:, src].contiguous(), delta * (k - 1))
    mt = y & (EVEN_MASK if delta > 0 else ODD_MASK)
    mb = y & (ODD_MASK if delta > 0 else EVEN_MASK)
    bits[:, dst] = shift1(mt) | shift1(mb)
    return mt, mb


def row_cases(r):
    """(name, segment, in place, rows) of the timed row-entry calls on an
    (B, r, W) state: a fused MAJ (T0, T1, T2 and dst; in place, dst is a
    source), a NOT pair (dst and DCC), a 1,000-hop shift chain
    (``shift_workload(1000)``'s)."""
    t0, t1, t2 = r - 3, r - 4, r - 5
    return [("bitwise_rows[maj]", "maj", False, ((0, 1, 2), (t0, t1, t2, 3))),
            ("bitwise_rows[maj]", "maj", True, ((0, 1, 2), (t0, t1, t2, 0))),
            ("bitwise_rows[not]", "not", False, ((7,), (8,))),
            ("bitwise_rows[not]", "not", True, ((7,), (7,))),
            ("shift_rows", "shift", False, (4, 5)),
            ("shift_rows", "shift", True, (4, 4))]


def phase_row_kernels(torch, device):
    """``bitwise_rows`` and ``shift_rows`` at ROW_SLOTS slots of ROW_SHAPE
    rows: bit for bit against their plain versions (every alias; shifts at
    ROW_KS both ways, in place and out of place), then each segment timed:
    the kernel's device time and per-call time, its plain version's, and
    the old lowering's (kernel plus glue, one CUDA graph), beside the bound
    (bytes: source rows read once, destination rows written once)."""
    from repro_torch.kernels.rowops import ops, ref

    r, w = ROW_SHAPE
    checks = 0
    for n in ROW_SLOTS:
        base = rows_from_seed(8, (n, r, w), torch, device)
        for name, seg, in_place, rows in row_cases(r):
            if seg == "shift":
                for delta in (1, -1):
                    for k in ROW_KS + (32 * w, 32 * w + 1):
                        got, exp = base.clone(), base.clone()
                        g = ops.shift_rows(got, *rows, delta, k)
                        e = ref.ref_shift_rows(exp, *rows, delta, k)
                        if not (torch.equal(got, exp)
                                and all(map(torch.equal, g, e))):
                            raise AssertionError(
                                f"shift_rows {rows} delta {delta} k {k} at "
                                f"{n} slots differs from plain")
                        checks += 1
                continue
            side = seg == "not"
            got, exp = base.clone(), base.clone()
            g = ops.bitwise_rows(got, seg, *rows, side=side)
            e = ref.ref_bitwise_rows(exp, seg, *rows, side=side)
            if not (torch.equal(got, exp)
                    and (not side or torch.equal(g, e))):
                raise AssertionError(f"{name} {rows} at {n} slots differs "
                                     "from plain")
            checks += 1
    out = {}
    for n in ROW_SLOTS:
        for name, seg, in_place, rows in row_cases(r):
            bits = rows_from_seed(8, (n, r, w), torch, device)
            if seg == "shift":
                calls = (lambda: ops.shift_rows(bits, *rows, 1, 1000),
                         lambda: ref.ref_shift_rows(bits, *rows, 1, 1000))
                moved = 1 + 3            # the source; dst, mt, mb
            else:
                side = seg == "not"
                calls = (lambda: ops.bitwise_rows(bits, seg, *rows,
                                                  side=side),
                         lambda: ref.ref_bitwise_rows(bits, seg, *rows,
                                                      side=side))
                moved = len(rows[0]) + len(rows[1]) + side
            old = lambda: old_lowering(torch, ops, bits, seg, rows)
            before = dict(ops.LAUNCHES)
            calls[0]()
            torch.cuda.synchronize()
            launched = sum(ops.LAUNCHES[k] - before[k] for k in before)
            if launched != 1:
                raise AssertionError(f"{name}: {launched} launches, not 1")
            nbytes = 4 * moved * n * w
            key = (f"{name} ({n}, {r}, {w}) "
                   f"{'in place' if in_place else 'out of place'}")
            out[key] = dict(
                name=name, slots=n, in_place=in_place,
                ms=device_us(calls[0], torch) / 1e3,
                call_ms=event_us(calls[0], torch) / 1e3,
                plain_ms=device_us(calls[1], torch) / 1e3,
                old_ms=device_us(old, torch) / 1e3,
                old_call_ms=event_us(old, torch) / 1e3,
                bytes=nbytes, bound_ms=nbytes / H100_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None, max_abs_err=0)
    for key, v in out.items():
        say(f"kernel {key}: kernel {v['ms'] * 1e3:.2f} us "
            f"({v['call_ms'] * 1e3:.2f} us per call with the host's launch),"
            f" old lowering {v['old_ms'] * 1e3:.2f} us "
            f"({v['old_call_ms'] * 1e3:.2f} us per call), plain "
            f"{v['plain_ms'] * 1e3:.2f} us, bound {v['bound_ms'] * 1e3:.3f} "
            f"us (bytes), max_abs_err 0")
    say(f"row entries: {checks} calls bit for bit against their plain "
        f"versions at {ROW_SLOTS} slots x {r} rows x {w} words, every alias;"
        " one launch per call")
    return out


class RowTally:
    """Within ``with``, counts the fused segments and residual SHIFT, TRA
    and NOT-to-DCC rows of every compiled program the executor runs on the
    card: the calls the row entries take, one launch each. Read from the
    compiled programs, not from the wrappers' counts."""

    def __init__(self):
        self.rows = 0

    def __enter__(self):
        from repro_torch.core.pim import exec as pim_exec
        from repro_torch.core.pim import ir
        from repro_torch.core.pim.compile import (SegMaj, SegNot, SegScan,
                                                  SegShiftRun)
        self._exec, self._run = pim_exec, pim_exec._run_segments
        kinds = (ir.OP_SHIFT, ir.OP_TRA, ir.OP_NOT2DCC)

        def spy(compiled, bits, *args):
            if bits.device.type == "cuda":
                for seg in compiled.segments:
                    if isinstance(seg, (SegMaj, SegNot, SegShiftRun)):
                        self.rows += 1
                    elif isinstance(seg, SegScan):
                        self.rows += sum(op.op in kinds for op in seg.ops)
            return self._run(compiled, bits, *args)

        pim_exec._run_segments = spy
        return self

    def __exit__(self, *exc):
        self._exec._run_segments = self._run
        return False


def launch_count(torch, name, fn) -> dict:
    """``fn`` once, warm, under the profiler, the segments it runs tallied:
    the card's operations (kernels, copies and fills) in the window, those
    of the row entries' kernels, and the segments and rows that took them.
    Fails unless the row entries launched once per segment and row (their
    counts), if the profiler saw more row kernels than that, or if an old
    out-of-place entry ran. The profiler has been seen to miss one kernel
    record of a few dozen on the card; a row kernel it misses must then
    show as a runtime launch call without a kernel record."""
    from repro_torch.kernels.rowops import ops
    fn()
    torch.cuda.synchronize()
    ops.reset_launches()
    with RowTally() as tally:
        sh = device_share(torch, fn)
    row_kernels = sum(k["count"] for k in sh["top"]
                      if "shift_rows_kernel" in k["name"]
                      or "bitwise_rows_kernel" in k["name"])
    scratch = ops.SHIFT_ROUTES["scratch"]
    kernels = sum(k["count"] for k in sh["top"]
                  if not k["name"].startswith(("Memcpy", "Memset")))
    rec = dict(device_ops=sum(k["count"] for k in sh["top"]),
               launch_calls=sh["launch_calls"], kernel_records=kernels,
               top=sh["top"],
               row_kernels=row_kernels, rows=tally.rows,
               wrapper_launches=ops.LAUNCHES["bitwise_rows"]
               + ops.LAUNCHES["shift_rows"], scratch_copies=scratch,
               old_entries=(ops.LAUNCHES["bitwise"]
                            + ops.LAUNCHES["shift_cols"]),
               before=BEFORE_OPS.get(name), wall_ms=sh["wall_ms"],
               device_ms=sh["device_ms"])
    unrecorded = rec["launch_calls"] - kernels
    if not (rec["wrapper_launches"] == rec["rows"] >= rec["row_kernels"]
            and rec["rows"] - rec["row_kernels"] <= unrecorded
            and rec["old_entries"] == 0):
        raise AssertionError(f"launches {name}: {rec}")
    return rec


def say_launches(counts: dict) -> None:
    say("launches per run (device operations in the profiler window; row "
        "kernels = fused segments + residual SHIFT/TRA/NOT rows, one launch "
        "each; before: torch ops the executor dispatched before the row "
        "entries, at commit edcfc58, counted on the CPU): " + "; ".join(
            f"{k} {v['device_ops']} ({v['wrapper_launches']} row-entry "
            f"launches for {v['rows']} segments and rows, "
            f"{v['row_kernels']} row kernels in the profiler, "
            f"{v['launch_calls'] - v['kernel_records']} launch calls "
            "without a kernel record"
            + (f", {v['scratch_copies']} scratch copies"
               if v["scratch_copies"] else "")
            + (f"; before {v['before']}" if v["before"] else "") + ")"
            for k, v in counts.items()))


def fold_tables_of(torch, device, m: int | None = None):
    """shift_workload(1000)'s event tables (4,001 rows) on ``device``, or
    their first ``m`` rows."""
    import numpy as np
    from repro_torch.core import pim
    f_tab, i_tab = pim.cost_tables(pim.shift_workload_program(1000, 512,
                                                              2048))
    return (torch.from_numpy(np.array(f_tab[:m])).to(device),
            torch.from_numpy(np.array(i_tab[:m])).to(device))


class FoldShapes:
    """Within ``with``, records the tables every ``meter_fold`` call on the
    card folds and keeps the largest (most rows); the wrapper itself, and
    its launch count, are untouched."""

    def __init__(self):
        self.calls, self.largest = 0, None

    def __enter__(self):
        from repro_torch.kernels.rowops import ops
        self._ops, self._fold = ops, ops.meter_fold

        def spy(f_tab, i_tab, f0, i0):
            if f0.device.type == "cuda":
                self.calls += 1
                if (self.largest is None
                        or f_tab.shape[0] > self.largest[0].shape[0]):
                    self.largest = (f_tab, i_tab)
            return self._fold(f_tab, i_tab, f0, i0)

        ops.meter_fold = spy
        return self

    def __exit__(self, *exc):
        self._ops.meter_fold = self._fold
        return False


def phase_fold_sweep(torch, device, fadd, largest):
    """meter_fold at FOLD_ROWS rows and at the largest table the paths
    folded (``largest``: its own field counts), onto FOLD_SLOTS slots: bit
    for bit against its plain version; device time beside the chain
    bound."""
    import numpy as np
    from repro_torch.kernels.rowops import ops, ref

    tables = [fold_tables_of(torch, device, m) for m in FOLD_ROWS]
    tables.append(largest)
    rng = np.random.default_rng(12)
    rows = []
    for f_tab, i_tab in tables:
        m, nf, ni = f_tab.shape[0], f_tab.shape[1], i_tab.shape[1]
        for slots in FOLD_SLOTS:
            f0 = torch.from_numpy((rng.random((slots, nf)) * 1e5)
                                  .astype(np.float32)).to(device)
            i0 = torch.from_numpy(rng.integers(0, 10**6, (slots, ni))
                                  .astype(np.int32)).to(device)
            got = ops.meter_fold(f_tab, i_tab, f0, i0)
            exp = ref.ref_meter_fold(f_tab, i_tab, f0, i0)
            if not (torch.equal(got[0].view(torch.int32),
                                exp[0].view(torch.int32))
                    and torch.equal(got[1], exp[1])):
                raise AssertionError(f"meter_fold m={m} slots={slots} "
                                     "differs from the numpy fold")
            nbytes = 4 * (m * (nf + ni) + 2 * slots * (nf + ni))
            bound_ms, bound_by = fold_bound_ms(m, nbytes, fadd)
            r = dict(m=m, slots=slots, nf=nf, ni=ni, bound_ms=bound_ms,
                     bound_by=bound_by,
                     ms=device_us(lambda: ops.meter_fold(f_tab, i_tab, f0,
                                                         i0), torch) / 1e3)
            rows.append(r)
            say(f"fold m={m} slots={slots} ({nf}+{ni} fields): kernel "
                f"{r['ms'] * 1e3:.2f} us, chain bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by}), "
                f"{r['ms'] / bound_ms:.2f}x the bound; bit for bit")
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


def run_device(torch, device, cfg, steps, verify=False):
    from repro_torch.core import pim
    dev = device_start(torch, device, cfg)
    results = []
    for programs, flags in steps:
        r = pim.schedule(dev, programs, verify=verify, **flags)
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
    busy share; one stream, so kernels do not overlap), every kernel, the
    longest first, the host's kernel-launch calls to the CUDA runtime
    (``launch_calls``) and to the driver (``driver_launch_calls``), and its
    CUDA-graph launches (``graph_launches``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels, launch_calls, driver_calls, graph_launches = [], 0, 0, 0
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launch_calls += e.count
        elif e.key.startswith("cuLaunchKernel"):
            driver_calls += e.count
        elif e.key.startswith("cudaGraphLaunch"):
            graph_launches += e.count
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
                    for k in kernels], "launch_calls": launch_calls,
            "driver_launch_calls": driver_calls,
            "graph_launches": graph_launches}


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
    route = f" [{r['route']}]" if "route" in r else ""
    beside = "".join(f", {other} route {r[f'{other}_ms'] * 1e3:.2f} us"
                     for other in ("tiled", "cuda_core")
                     if f"{other}_ms" in r)
    say(f"kernel {name}{route} {r['shape']}: kernel {r['ms'] * 1e3:.2f} us "
        f"({r['call_ms'] * 1e3:.2f} us per call with the host's launch), "
        f"plain {r['plain_ms'] * 1e3:.2f} us, library "
        f"{r['library_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us "
        f"({r['bound_by']}){beside}, max_abs_err {r['max_abs_err']:.3e}")


def cycled(copies):
    """``fn`` -> a callable that calls ``fn(*copies[i % len(copies)])``
    with i counting its calls: each call finds other operands."""
    def wrap(fn):
        calls = iter(range(10**9))
        return lambda: fn(*copies[next(calls) % len(copies)])
    return wrap


def phase_lm_kernels(torch, device):
    """pim_matmul and flash_attn at the serving path's shapes, each against
    its plain version on the same tensors; name -> row."""
    from repro_torch.kernels.pim_matmul import ops as pm
    from repro_torch.kernels.pim_matmul import ref as pref

    gen = torch.Generator(device=device).manual_seed(11)
    rows = {}
    for m, k, n in PIM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=device).to(
            torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device)
        decode = m < pm.TC_MIN_M
        for bits in (4, 8):
            w_int, scales = pm.quantize(w, bits)
            w_deq = pref.ref_dequant(w_int, scales, bits).to(
                torch.bfloat16)
            # decode: the timed calls cycle over WEIGHT_COPIES copies
            copies = [(w_int, w_deq)] + [
                (w_int.clone(), w_deq.clone())
                for _ in range(WEIGHT_COPIES - 1 if decode else 0)]
            out = torch.empty((m, n), device=device)
            for mode in ("shift_add", "dequant"):
                def kernel(w_int, w_deq, x=x, scales=scales, mode=mode,
                           bits=bits):
                    return pm.pim_matmul(x, w_int, scales, mode=mode,
                                         bits=bits)

                def plain(w_int, w_deq, x=x, scales=scales, mode=mode,
                          bits=bits):
                    return pref.ref_pim_matmul_raw(
                        x, w_int, mode=mode, bits=bits) * scales[None, :]

                got, exp = kernel(w_int, w_deq), plain(w_int, w_deq)
                torch.cuda.synchronize()
                err = max_abs_err(got, exp)
                top = float(exp.abs().max())
                if not (torch.isfinite(got).all() and err <= PIM_REL * top):
                    raise AssertionError(
                        f"pim_matmul {mode} w{bits} ({m}, {k}, {n}): "
                        f"max abs err {err} > {PIM_REL} x {top}")
                name = f"pim_matmul[{mode},w{bits}] ({m},{k})@({k},{n})"
                cyc = cycled(copies)
                rows[name] = _kernel_row(
                    torch, cyc(kernel), cyc(plain),
                    cyc(lambda w_int, w_deq, x=x: torch.matmul(x, w_deq)),
                    2 * m * k + k * n + 4 * n + 4 * m * n, 2 * m * k * n,
                    f"x ({m}, {k}) bf16, w ({k}, {n}) int{bits}"
                    + (f", {len(copies)} weight copies cycled"
                       if decode else ""), err)
                rows[name]["route"] = pm.route(m, k, n, x.dtype)
                if decode:
                    rows[name]["cuda_core_ms"] = device_us(
                        cyc(lambda w_int, w_deq, x=x, scales=scales,
                            out=out, mode=mode, bits=bits:
                            pm._launch(x, w_int, scales, out, mode, bits,
                                       "cuda_core")),
                        torch, 5, 5) / 1e3
                _say_row(name, rows[name])
                del got, exp
            del copies
    for phase, shape in FLASH_SHAPES.items():
        name = f"flash_attn[{phase}]"
        rows[name] = flash_row(torch, device, gen, shape)
        _say_row(name, rows[name])
    return rows


def flash_operands(torch, device, gen, shape):
    """q, k, v (float32), positions and the seen mask (B, Sq, Sk) of one
    FLASH_SHAPES entry; unwritten slots hold kpos -1 and poisoned
    values."""
    B, KV, G, dk, dv, sq, sk, last, window, ring = shape
    q = torch.randn((B, sq, KV, G, dk), generator=gen, device=device)
    k = torch.randn((B, sk, KV, dk), generator=gen, device=device)
    v = torch.randn((B, sk, KV, dv), generator=gen, device=device)
    pos_q = torch.arange(last - sq + 1, last + 1, dtype=torch.int32,
                         device=device)
    slots = torch.arange(sk, dtype=torch.int32, device=device)
    if ring:      # slot j holds the latest position p <= last, p = j mod sk
        pos_k = (last - torch.remainder(last - slots, sk)).repeat(B, 1)
    else:
        pos_k = slots.repeat(B, 1)
        pos_k[:, last + 1:] = -1
    v[pos_k < 0] = 1e4                # unwritten slots must weigh 0
    seen = ((pos_k[:, None, :] >= 0)
            & (pos_k[:, None, :] <= pos_q[None, :, None]))   # (B, Sq, Sk)
    if window is not None:
        seen &= (pos_q[None, :, None] - pos_k[:, None, :]) < window
    return q, k, v, pos_q, pos_k, seen


def flash_row(torch, device, gen, shape):
    """One flash_attn shape: the kernel of the route ops.route gives it
    against its plain version in float32 and bf16, then timed in bf16
    beside the plain version and SDPA (timed only; the port never calls
    it); a tensor-core row also times the tiled route on the same
    tensors."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.flash_attn import ref as fref

    B, KV, G, dk, dv, sq, sk, last, window, ring = shape
    q, k, v, pos_q, pos_k, seen = flash_operands(torch, device, gen, shape)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        args = (q.to(dt), k.to(dt), v.to(dt), pos_q, pos_k)
        got = fa.flash_attention(*args, window=window)
        exp = fref.ref_flash_attention(*args, window=window)
        torch.cuda.synchronize()
        err = max_abs_err(got.float(), exp.float())
        bound = (FLASH_F32_ABS if dt == torch.float32 else
                 FLASH_BF16_REL * float(exp.float().abs().max()))
        if not (got.shape == exp.shape and torch.isfinite(got.float()).all()
                and err < bound):
            raise AssertionError(f"flash_attn {shape} {dt}: max abs err "
                                 f"{err} >= {bound:.3e}")
        errs[str(dt).split(".")[-1]] = err
        del got, exp
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    qt = qb.reshape(B, sq, KV * G, dk).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kb, vb))
    mask = seen[:, None]
    pairs = int(seen.sum())
    row = _kernel_row(
        torch,
        lambda: fa.flash_attention(qb, kb, vb, pos_q, pos_k, window=window),
        lambda: fref.ref_flash_attention(qb, kb, vb, pos_q, pos_k,
                                         window=window),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True),
        2 * (qb.numel() + kb.numel() + vb.numel() + B * sq * KV * G * dv)
        + 4 * (pos_q.numel() + pos_k.numel()),
        2 * (dk + dv) * KV * G * pairs,
        f"q ({B}, {sq}, {KV}, {G}, {dk}), k ({B}, {sk}, {KV}, {dk}), v "
        f"(.., {dv}) bf16{'' if window is None else f', window {window}'}"
        f"{', ring' if ring else ''}, {pairs} seen (query, key) pairs",
        errs["bfloat16"], per_graph=10, reps=10)
    row["route"] = fa.route(sq, G, torch.bfloat16, dk, dv)
    row["max_abs_err_f32"] = errs["float32"]
    if row["route"] == "tensor_core":
        out = torch.empty(qb.shape[:-1] + (dv,), dtype=qb.dtype,
                          device=device)
        row["tiled_ms"] = device_us(lambda: fa._launch(
            qb, kb, vb, pos_q, pos_k, out, window, dk ** -0.5, "tiled"),
            torch, 5, 5) / 1e3
        del out
    if row["route"] == "split_kv":
        row["splits"] = fa._splits(B * KV, sq * G, sk, dk, dv, 1,
                                   device.index or 0)
    del q, k, v, qb, kb, vb, qt, kt, vt
    return row


def flash_routes_timed(torch, device):
    """Device us of the three flash routes, bf16, at Qwen3-4B's heads (B
    4, KV 8, G 4, dh 128) for each Sq of FLASH_THRESHOLD_SQ and Sk of
    FLASH_THRESHOLD_SK, the queries at the last positions; then of the
    split route at each count of FLASH_SPLITS and its own at the decode
    shapes of FLASH_SHAPES."""
    from repro_torch.kernels.flash_attn import ops as fa

    gen = torch.Generator(device=device).manual_seed(19)
    times = {}
    for sk in FLASH_THRESHOLD_SK:
        for sq in FLASH_THRESHOLD_SQ:
            q, k, v, pos_q, pos_k, _ = flash_operands(
                torch, device, gen, (4, 8, 4, 128, 128, sq, sk, sk - 1, None,
                                     False))
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            out = torch.empty_like(q)
            times[f"rows {4 * sq}, Sk {sk}"] = {
                which: device_us(lambda which=which: fa._launch(
                    q, k, v, pos_q, pos_k, out, None, 128 ** -0.5, which),
                    torch, 5, 5)
                for which in FLASH_ROUTES}
            del q, k, v, out
    say(f"route threshold flash_attn (B 4, KV 8, G 4, dh 128, bf16), "
        f"SPLIT_MAX_ROWS {fa.SPLIT_MAX_ROWS}: " + "; ".join(
            f"{key}: " + ", ".join(f"{w} {t[w]:.2f} us" for w in FLASH_ROUTES)
            for key, t in times.items()))
    splits = {}
    for phase, shape in FLASH_SHAPES.items():
        B, KV, G, dk, dv, sq, sk, last, window, ring = shape
        if fa.route(sq, G, torch.bfloat16, dk, dv) != "split_kv":
            continue
        q, k, v, pos_q, pos_k, _ = flash_operands(torch, device, gen, shape)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out = torch.empty(q.shape[:-1] + (dv,), dtype=q.dtype, device=device)
        chosen = fa._splits(B * KV, sq * G, sk, dk, dv, 1, device.index or 0)
        us = {n: device_us(lambda n=n: fa._launch(
            q, k, v, pos_q, pos_k, out, window, dk ** -0.5, "split_kv", n),
            torch, 5, 5) for n in sorted({chosen, *FLASH_SPLITS})}
        splits[phase] = {"chosen": chosen, "us": us}
        say(f"splits flash_attn[{phase}] chosen {chosen}: " + ", ".join(
            f"{n}: {t:.2f} us" for n, t in us.items()))
        del q, k, v, out
    return {"threshold_us": times, "splits": splits}


def pim_routes_timed(torch, device):
    """Device us of the pim_matmul routes at the threshold's M, of the
    tensor-core kernel at each K split count at M = 512 and of the
    swapped kernel at each at M = 4 (w4 shift_add); the calls cycle over
    WEIGHT_COPIES copies of the weights."""
    from repro_torch.kernels.pim_matmul import ops as pm

    gen = torch.Generator(device=device).manual_seed(17)

    def operands(m, k, n):
        x = torch.randn((m, k), generator=gen, device=device).to(
            torch.bfloat16)
        w_int, scales = pm.quantize(
            torch.randn((k, n), generator=gen, device=device), 4)
        copies = [(w_int,)] + [(w_int.clone(),)
                               for _ in range(WEIGHT_COPIES - 1)]
        return x, copies, scales, torch.empty((m, n), device=device)

    def timed(ops, which, splits=None):
        x, copies, scales, out = ops
        return device_us(cycled(copies)(
            lambda w_int: pm._launch(x, w_int, scales, out, "shift_add", 4,
                                     which, splits)), torch, 5, 5)

    threshold = {}
    for m in THRESHOLD_MS:
        ops = operands(m, 2560, 9728)
        threshold[m] = {r: timed(ops, r) for r in PIM_ROUTES
                        if r != "swap_ab" or m < pm.TC_MIN_M}
        del ops
    say(f"route threshold (M, 2560) @ (2560, 9728) w4, {WEIGHT_COPIES} "
        f"weight copies cycled, TC_MIN_M {pm.TC_MIN_M}: " + "; ".join(
            f"M {m}: " + ", ".join(f"{r} {us:.2f} us" for r, us in t.items())
            for m, t in threshold.items()))
    lib = pm._lib()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = {}
    for which, label, rule, counts, shapes in (
            ("tensor_core", "tc", lib.pim_matmul_tc_splits, TC_SPLITS,
             PIM_SHAPES[2:]),
            ("swap_ab", "swap_ab", lib.pim_matmul_swap_splits, SWAP_SPLITS,
             PIM_SHAPES[:2])):
        for m, k, n in shapes:
            ops = operands(m, k, n)
            chosen = rule(m, k, n, 4, sms)
            times = {s: timed(ops, which, s)
                     for s in sorted({chosen, *counts})}
            splits[f"{label} ({m},{k})@({k},{n})"] = {"chosen": chosen,
                                                      "us": times}
            say(f"splits pim_matmul[{label}] ({m},{k})@({k},{n}) w4, "
                f"chosen {chosen}: " + ", ".join(f"{s}: {t:.2f} us"
                                                 for s, t in times.items()))
            del ops
    return {"threshold_us": threshold, "splits": splits}


def ptxas(library, kernel, key):
    """Registers, static shared memory and spill bytes ptxas reported for
    each kernel instance of ``library`` whose mangled name matches the
    regex ``kernel``, under ``key(match)``; empty where this process did
    not build the library."""
    import re
    from repro_torch.kernels import _build

    out = {}
    for part in _build.BUILD_LOG.get(library, "").split(
            "Compiling entry function")[1:]:
        match = re.search(kernel, part)
        if match is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        smem = re.search(r"(\d+) bytes smem", part)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", part)
        out[key(match)] = {
            "registers": int(regs.group(1)),
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
            "spill_bytes": int(spills.group(1)) + int(spills.group(2))}
    return out


def tc_ptxas():
    """ptxas's report of each instance of the tensor-core kernel, and its
    dynamic shared memory."""
    from repro_torch.kernels.pim_matmul import ops as pm
    return {"dynamic_smem_bytes": pm._lib().pim_matmul_tc_smem_bytes(),
            **ptxas("pim_matmul", r"pim_matmul_tc_kernelILi(\d+)E",
                    lambda m: f"bits{m.group(1)}")}


def flash_ptxas():
    """ptxas's report of each instance of the split route's two kernels
    ("split bf16 rb4", ..., "merge f32")."""
    return ptxas(
        "flash_attn",
        r"flash_(split|merge)_kernelI(13__nv_bfloat16|f)(?:Li(\d+)E)?",
        lambda m: (f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'bf16'}"
                   + (f" rb{m.group(3)}" if m.group(3) else "")))


# flash's tensor-core instances that must not spill: the serving path's
# (128, 128), MLA's prefill (192, 128) and recurrentgemma's (256, 256)
FLASH_TC_NO_SPILL = ("128/128", "192/128", "256/256")


def flash_tc_ptxas():
    """ptxas's report of each instance of flash's tensor-core kernel
    ("128/128": dk and dv widths), and its dynamic shared memory at the
    prefill shapes."""
    import torch
    from repro_torch.kernels.flash_attn import ops as fa
    lib = fa._lib()
    smem = {}
    for phase, (_, _, G, dk, dv, sq, sk, *_) in FLASH_SHAPES.items():
        if fa.route(sq, G, torch.bfloat16, dk, dv) == "tensor_core":
            smem[phase] = lib.flash_attn_tc_smem_bytes(dk, dv, sk)
    return {"dynamic_smem_bytes": smem,
            **ptxas("flash_attn", r"flash_tc_kernelILi(\d+)ELi(\d+)E",
                    lambda m: f"{m.group(1)}/{m.group(2)}")}


def sass_opcodes(library, kernel, key):
    """Opcode counts (a ``collections.Counter``, "IMAD.MOV" counted as
    "IMAD") of each instance of ``library``'s kernels whose mangled name
    matches ``kernel``, from ``cuobjdump -sass`` of the built library,
    under ``key(match)``."""
    import collections
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(_build.library_path(library))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        match = re.match(r"\S*" + kernel, part)
        if match is not None:
            counts[key(match)] = collections.Counter(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+([A-Z][A-Z0-9]*)", part))
    return counts


def hmma_counts(library, kernel, key):
    """HMMA instructions in each instance of ``library``'s kernels whose
    mangled name matches ``kernel`` (see ``sass_opcodes``)."""
    return {k: c["HMMA"] for k, c in sass_opcodes(library, kernel,
                                                  key).items()}


def tc_sass():
    """HMMA instructions in each instance of pim_matmul's tensor-core
    kernel (bits -> count)."""
    return hmma_counts("pim_matmul", r"pim_matmul_tc_kernelILi(\d+)E",
                       lambda m: f"bits{m.group(1)}")


SWAP_KERNEL = r"pim_matmul_swap_kernelILi(\d+)ELi(\d+)E"


def swap_key(match):
    return f"bits{match.group(1)} mf{match.group(2)}"


def swap_ptxas():
    """ptxas's report of each instance of pim_matmul's swapped-operand
    kernel ("bits4 mf1": planes, n8 fragments of the batch)."""
    return ptxas("pim_matmul", SWAP_KERNEL, swap_key)


# The swapped kernel's loop body is two k16 steps, 64 weight codes per lane
# each; its integer instructions by pipe, at NVIDIA's per-SM rates for
# compute capability 9.0: logic, shifts, permutes and adds on the 64-lane
# integer pipe; IMAD on the FMA pipe, 64 lanes; conversions at 16.
SWAP_CODES_PER_PASS = 2 * 64
SWAP_PIPES = {"alu": (("LOP3", "PRMT", "SHF", "IADD3", "LEA", "ISETP",
                       "SEL", "VIADD"), 64),
              "imad": (("IMAD",), 64),
              "conversion": (("I2F", "F2FP", "F2F"), 16)}


def swap_sass():
    """Each instance of the swapped kernel: its HMMA count and its integer
    instructions per weight code by pipe (the static count of the whole
    kernel over the 128 codes a lane takes in one pass of its two-step
    loop, so the one-time prologue and epilogue count too)."""
    out = {}
    for key, ops in sass_opcodes("pim_matmul", SWAP_KERNEL,
                                 swap_key).items():
        out[key] = {"HMMA": ops["HMMA"], "per_code": {
            pipe: sum(ops[o] for o in names) / SWAP_CODES_PER_PASS
            for pipe, (names, _) in SWAP_PIPES.items()}}
    return out


def swap_integer_floor_ms(per_code, codes):
    """The least time ``codes`` weight codes' integer work takes on one
    H100: the busiest pipe's instructions over its lanes x 132 SMs x 1.98
    GHz."""
    return max(per_code[pipe] * codes / (lanes * 132 * 1.98e9)
               for pipe, (_, lanes) in SWAP_PIPES.items()) * 1e3


def flash_tc_sass():
    """HMMA instructions in each instance of flash's tensor-core kernel
    ("128/128" -> count)."""
    return hmma_counts("flash_attn", r"flash_tc_kernelILi(\d+)ELi(\d+)E",
                       lambda m: f"{m.group(1)}/{m.group(2)}")


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


def argmax_chain(torch, cfg, logits):
    """(B, n) int32: the argmax of each step's (B, 1, V) logits."""
    return torch.stack([torch.argmax(lg[:, 0, :cfg.vocab_size], -1)
                        for lg in logits], dim=1).to(torch.int32)


def run_serve(torch, device):
    """The serving path at full width and depth: ``greedy_generate`` as one
    CUDA-graph replay per call, beside the eager prefill and decode steps.
    Returns (record, launches, routes and flash routes of one replayed
    call)."""
    import gc

    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.pim_matmul import ops as pm
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import engine
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
    L, V = cfg.n_layers, cfg.vocab_size

    def generate():
        return greedy_generate(cfg, model, batch, max_new_tokens=SERVE_NEW)

    def counted(fn):
        """``fn()`` with the launch counts and DECODE_STATS reset just
        before it and read just after it, and its ms."""
        pm.reset_launches()
        fa.reset_launches()
        engine.DECODE_STATS["dispatches"] = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, dict(
            launches={"pim_matmul": pm.LAUNCHES["pim_matmul"],
                      "flash_attn": fa.LAUNCHES["flash_attn"]},
            routes=dict(pm.ROUTES), flash_routes=dict(fa.ROUTES),
            dispatches=engine.DECODE_STATS["dispatches"])

    # the first call of the signature (warm-up: an eager prefill and decode
    # step; capture; one replay), then a replayed call
    out, first_ms, first = counted(generate)
    (graph,) = model.generate_graphs.values()
    again, _, counts = counted(generate)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if tuple(out.shape) != (SERVE_BATCH, SERVE_NEW) \
            or out.dtype != torch.int32 or int(out.min()) < 0 \
            or int(out.max()) >= V or not torch.equal(out, again):
        raise AssertionError(f"greedy_generate gave {tuple(out.shape)} "
                             f"{out.dtype} tokens in [{int(out.min())}, "
                             f"{int(out.max())}], equal on replay: "
                             f"{torch.equal(out, again)}")
    launches = counts["launches"]
    expected = {"pim_matmul": 3 * L * SERVE_NEW, "flash_attn": L * SERVE_NEW}
    if launches != expected:
        raise AssertionError(f"serving launches {launches}, expected "
                             f"{expected}")
    # the first call adds its warm-up's eager prefill and decode step
    warm = {k: v // SERVE_NEW * (SERVE_NEW + 2) for k, v in expected.items()}
    if first["launches"] != warm:
        raise AssertionError(f"first call's launches {first['launches']}, "
                             f"expected {warm}")
    if counts["dispatches"] != 1 or first["dispatches"] != 1:
        raise AssertionError(f"DECODE_STATS per call: first "
                             f"{first['dispatches']}, replayed "
                             f"{counts['dispatches']}, expected 1")
    # prefill's FFN linears (M = batch x prompt) on the tensor cores, each
    # decode step's (M = batch) on the swapped operands
    routes = counts["routes"]
    expected = {"tensor_core": 3 * L, "swap_ab": 3 * L * (SERVE_NEW - 1),
                "cuda_core": 0}
    if routes != expected:
        raise AssertionError(f"serving routes {routes}, expected "
                             f"{expected}")
    # prefill's attention (Sq·G = 512 rows per pair, bf16) on the tensor
    # cores, each decode step's (4 rows) split over the keys
    flash_routes = counts["flash_routes"]
    expected = {"tensor_core": L, "tiled": 0, "split_kv": L * (SERVE_NEW - 1)}
    if flash_routes != expected:
        raise AssertionError(f"serving flash routes {flash_routes}, "
                             f"expected {expected}")
    engine.DECODE_STATS["dispatches"] = 0
    zero = greedy_generate(cfg, model, batch, max_new_tokens=0)
    if zero.shape != (SERVE_BATCH, 0) or engine.DECODE_STATS["dispatches"]:
        raise AssertionError("zero new tokens: a dispatch was counted")

    # the graph's tokens are the eager loop's argmax chain, bit for bit
    max_len = SERVE_PROMPT + SERVE_NEW
    forced = teacher_forced(cfg, model, prompt, out, device)
    chain = argmax_chain(torch, cfg, forced)
    if not all(torch.isfinite(lg).all() for lg in forced) \
            or not torch.equal(chain, out):
        raise AssertionError(
            f"the graph's tokens are not the eager loop's argmax chain: "
            f"{int((chain != out).sum())} of {out.numel()} differ")
    logits = forced[0]
    _, caches = prefill(cfg, model, {"tokens": prompt[:, :-1]}, max_len)
    dec, _ = decode_step(cfg, model, {"tokens": prompt[:, -1:]},
                         SERVE_PROMPT - 1, caches)
    dvp = rel_err(torch, dec, logits)
    if not dvp < LOGITS_REL:
        raise AssertionError(f"decode vs prefill logits: rel {dvp} >= "
                             f"{LOGITS_REL}")
    del forced, logits, dec

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
    eager_ms = statistics.median(
        timed(lambda: teacher_forced(cfg, model, prompt, out, device))
        for _ in range(3))
    replay_ms = [timed(generate) for _ in range(3)]
    generate_ms = statistics.median(replay_ms)
    # the graph alone on the card's clock (CUDA events around one replay)
    graph_ms = event_us(graph.graph.replay, torch, reps=3, warmup=1) / 1e3

    _, caches = prefill(cfg, model, batch, max_len)
    shares = {
        "prefill": device_share(torch, lambda: prefill(cfg, model, batch,
                                                       max_len)),
        "decode step": device_share(torch, lambda: decode_step(
            cfg, model, {"tokens": out[:, :1]}, SERVE_PROMPT, caches)),
        "greedy_generate (replayed)": device_share(torch, generate),
    }
    replayed = shares["greedy_generate (replayed)"]
    if replayed["graph_launches"] != 1 or replayed["launch_calls"] \
            or replayed["driver_launch_calls"]:
        raise AssertionError(
            f"a replayed call made {replayed['graph_launches']} graph "
            f"launches and {replayed['launch_calls']} + "
            f"{replayed['driver_launch_calls']} kernel launches; expected "
            "1 and 0")
    # the kernels the graph holds: prefill's and SERVE_NEW - 1 decode
    # steps', from the eager profiles
    kernels_ms = (shares["prefill"]["device_ms"]
                  + (SERVE_NEW - 1) * shares["decode step"]["device_ms"])
    record = dict(
        config=dict(arch=cfg.arch_id, quant=cfg.quant,
                    quant_mode=cfg.quant_mode, n_layers=L,
                    d_model=cfg.d_model, vocab=V, batch=SERVE_BATCH,
                    prompt=SERVE_PROMPT, new_tokens=SERVE_NEW),
        init_s=init_s, first_generate_ms=first_ms,
        warmup_ms=graph.warmup_s * 1e3, capture_ms=graph.capture_s * 1e3,
        graph_pool_bytes=graph.pool_bytes, weights_gb=weights_gb,
        peak_gb=peak_gb, prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
        eager_loop_ms=eager_ms, generate_ms=generate_ms,
        generate_replays_ms=replay_ms, graph_ms=graph_ms,
        graph_kernels_ms=kernels_ms, first_call=first,
        decode_vs_prefill_rel=dvp, tokens=out.cpu().tolist(),
        profile=shares, routes=routes, flash_routes=flash_routes)
    say(f"serve {cfg.arch_id} {cfg.quant} {cfg.quant_mode} ({L} layers, "
        f"d_model {cfg.d_model}): batch {SERVE_BATCH}, prompt "
        f"{SERVE_PROMPT}, {SERVE_NEW} new tokens; eager: prefill "
        f"{prefill_ms:.2f} ms, decode {decode_ms:.2f} ms per token, the "
        f"loop (prefill + {SERVE_NEW - 1} steps) {eager_ms:.2f} ms; "
        f"{weights_gb:.2f} GB of weights on the card, peak {peak_gb:.2f} "
        f"GB; decode vs prefill logits rel {dvp:.3e} (bound {LOGITS_REL}); "
        f"launches per call {json.dumps(launches)}")
    say(f"serve greedy_generate as one CUDA graph: first call "
        f"{first_ms:.2f} ms (warm-up {graph.warmup_s * 1e3:.2f} ms, capture "
        f"{graph.capture_s * 1e3:.2f} ms, then one replay; launches "
        f"{json.dumps(first['launches'])}); replayed call {generate_ms:.2f} "
        f"ms (median of " + ", ".join(f"{t:.2f}" for t in replay_ms)
        + f"), the graph alone {graph_ms:.2f} ms on the card's clock, "
        f"{kernels_ms:.3f} ms of kernels in it (eager profiles); graph pool "
        f"{graph.pool_bytes} bytes; DECODE_STATS 1 per call, 0 for zero "
        f"tokens; tokens == the eager loop's argmax chain, bit for bit; "
        f"{replayed['graph_launches']} cudaGraphLaunch and "
        f"{replayed['launch_calls'] + replayed['driver_launch_calls']} "
        "kernel launches per replayed call")
    for name, sh in shares.items():
        say_share(f"serve {name}", sh)
    flash_ms = {name: sum(k["ms"] for k in sh["top"] if "flash_" in k["name"])
                for name, sh in shares.items()}
    # pim_matmul's kernels and the ordered sum of their K splits
    pim_ms = {name: sum(k["ms"] for k in sh["top"]
                        if "pim_matmul" in k["name"]
                        or "reduce_splits" in k["name"])
              for name, sh in shares.items()}
    record["flash_ms"], record["pim_matmul_ms"] = flash_ms, pim_ms
    say(f"serve prefill: {shares['prefill']['device_ms']:.3f} ms of "
        f"kernels, pim_matmul {pim_ms['prefill']:.3f} ms and flash_attn "
        f"{flash_ms['prefill']:.3f} ms of it (with the tiled kernel at "
        f"prefill, one H100 took 44.793 ms, flash 3.619 ms of it)")
    say(f"serve decode step: {shares['decode step']['device_ms']:.3f} ms of "
        f"kernels, pim_matmul {pim_ms['decode step']:.3f} ms and flash_attn "
        f"{flash_ms['decode step']:.3f} ms of it (with the CUDA-core "
        f"pim_matmul at decode, one H100 took 17.05-17.19 ms, pim_matmul "
        f"10.048 ms of it)")
    del model, caches, graph
    gc.collect()
    torch.cuda.empty_cache()
    record["left_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    say(f"serve: {record['left_gb']:.3f} GB still allocated after the model "
        "and its graphs are freed")
    return record, launches, routes, flash_routes


def run_lm_parity(torch, device):
    """Full width, PARITY_LAYERS layers: greedy_generate on the card (one
    graph replay), its tokens the card's eager argmax chain; then the same
    weights and tokens teacher-forced on the CPU, and the CPU's eager
    greedy_generate, whose tokens must equal the card's wherever the card's
    top-2 margin exceeds twice the bound."""
    from repro_torch.models import init_params
    from repro_torch.serve import engine
    from repro_torch.serve.engine import greedy_generate

    cfg = lm_config(n_layers=PARITY_LAYERS)
    model = init_params(cfg, 1, device=device)
    prompt = prompt_tokens(torch, 13, PARITY_BATCH, PARITY_PROMPT,
                           cfg.vocab_size, device)
    engine.DECODE_STATS["dispatches"] = 0
    toks = greedy_generate(cfg, model, {"tokens": prompt},
                           max_new_tokens=PARITY_NEW)
    if engine.DECODE_STATS["dispatches"] != 1:
        raise AssertionError("lm parity: not one dispatch on the card")
    card = [lg.cpu() for lg in teacher_forced(cfg, model, prompt, toks,
                                              device)]
    toks = toks.cpu()
    if not torch.equal(toks, argmax_chain(torch, cfg, card)):
        raise AssertionError("lm parity: the graph's tokens are not the "
                             "argmax chain")
    model.to("cpu")
    if model.generate_graphs:
        raise AssertionError("lm parity: moving the model kept its graphs")
    t = time.perf_counter()
    cpu = teacher_forced(cfg, model, prompt.cpu(), toks, "cpu")
    cpu_toks = greedy_generate(cfg, model, {"tokens": prompt.cpu()},
                               max_new_tokens=PARITY_NEW, device="cpu")
    cpu_s = time.perf_counter() - t
    rels = [rel_err(torch, a, b) for a, b in zip(card, cpu)]
    if not all(torch.isfinite(a).all() for a in card) \
            or max(rels) >= LOGITS_REL:
        raise AssertionError(f"lm parity: card vs CPU logits rel {rels} "
                             f"(bound {LOGITS_REL})")
    checked = 0
    for b in range(PARITY_BATCH):
        for t, lg in enumerate(card):
            row = lg[b, 0, :cfg.vocab_size].double()
            top2 = row.topk(2).values
            if top2[0] - top2[1] <= 2 * LOGITS_REL * row.abs().max():
                break
            if cpu_toks[b, t] != toks[b, t]:
                raise AssertionError(f"lm parity: request {b} token {t}: "
                                     f"CPU {int(cpu_toks[b, t])}, card "
                                     f"{int(toks[b, t])}")
            checked += 1
    say(f"lm parity {cfg.arch_id} {cfg.quant} {cfg.quant_mode} at full "
        f"width, {PARITY_LAYERS} layers, batch {PARITY_BATCH}, prompt "
        f"{PARITY_PROMPT}, {PARITY_NEW} tokens: card (one graph replay, "
        f"kernels) vs CPU (eager, plain versions) logits rel per step "
        + ", ".join(f"{r:.3e}" for r in rels)
        + f" (bound {LOGITS_REL}); the CPU's greedy tokens: "
        f"{int((cpu_toks == toks).sum())} of {toks.numel()} equal to the "
        f"card's, {checked} held to them (those before a card top-2 margin "
        f"within twice the bound); CPU run {cpu_s:.1f} s")
    return {"rel_per_step": rels, "cpu_s": cpu_s,
            "tokens": toks.tolist(), "cpu_tokens": cpu_toks.tolist(),
            "tokens_checked": checked}


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


# ---------------------------------------------------------------------------
# Phase 9: ripple_add against its plain version; fused against composed
# ---------------------------------------------------------------------------

def ripple_library(torch, width):
    """One PyTorch call that computes ``ripple_add`` at ``width``, with its
    name, or (None, "none"). At w 1 the interior mask is 0 and no carry
    moves, so the add is ``a ^ b``; at w 8, 16 and 32 little-endian packing
    and wrap-around addition make it one ``torch.add`` on the rows viewed
    as uint8, int16 or int32. w 2 and 4 have no such call."""
    if width == 1:
        return (lambda x, y: torch.bitwise_xor(x, y)), "torch.bitwise_xor"
    dt = {8: "uint8", 16: "int16", 32: "int32"}.get(width)
    if dt is None:
        return None, "none"
    view = getattr(torch, dt)
    return (lambda x, y: torch.add(x.view(view), y.view(view))
            .view(torch.int32)), f"torch.add on {dt}"


def phase_ripple(torch, device):
    """ripple_add at every width: exact against its plain version; device,
    plain and library times and the bound. Returns (rows, fused record)."""
    from repro_torch.kernels.rowops import ops, ref

    n, w = RIPPLE_SHAPE
    # RIPPLE_PAIRS operand pairs (64 MiB) cycled through by the timed
    # calls, so that each call finds its inputs outside the 50 MB L2, as
    # the HBM bound assumes
    pairs = [(rows_from_seed(40 + 2 * i, (n, w), torch, device),
              rows_from_seed(41 + 2 * i, (n, w), torch, device))
             for i in range(RIPPLE_PAIRS)]
    a, b = pairs[0]
    for shape in RIPPLE_RAGGED:
        ra = rows_from_seed(33, shape, torch, device)
        rb = rows_from_seed(34, shape, torch, device)
        for width in WIDTHS:
            if not torch.equal(ops.ripple_add(ra, rb, width=width),
                               ref.ref_ripple_add(ra, rb, width)):
                raise AssertionError(f"ripple_add w{width} {shape} differs "
                                     "from plain")

    cycled_pairs = cycled(pairs)
    rows = {}
    for width in WIDTHS:
        for pa, pb in pairs:
            got = ops.ripple_add(pa, pb, width=width)
            exp = ref.ref_ripple_add(pa, pb, width)
            if not torch.equal(got, exp):
                raise AssertionError(f"ripple_add w{width} differs from "
                                     "plain")
        got = ops.ripple_add(a, b, width=width)
        exp = ref.ref_ripple_add(a, b, width)
        if not torch.equal(got.cpu(), ref.ref_ripple_add(a.cpu(), b.cpu(),
                                                         width)):
            raise AssertionError(f"ripple_add w{width} differs from plain "
                                 "on the CPU")
        library, lib_note = ripple_library(torch, width)
        if library is not None and not all(
                torch.equal(library(pa, pb), ops.ripple_add(pa, pb,
                                                            width=width))
                for pa, pb in pairs):
            library, lib_note = None, f"none ({lib_note} differs)"
        # Operations: the masked lane add, ((a & ~H) + (b & ~H)) ^ ((a ^ b)
        # & H), four logic operations and one add per word at every width,
        # as nvcc emits them (LOP3 and IADD3 on the integer pipe; the sass
        # line counts them).
        nbytes = 12 * n * w
        nops = 5 * n * w
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = nops / H100_INT32_OPS_PER_S * 1e3
        kernel = lambda x, y, width=width: ops.ripple_add(x, y, width=width)
        r = dict(
            ms=device_us(cycled_pairs(kernel), torch) / 1e3,
            call_ms=event_us(cycled_pairs(kernel), torch) / 1e3,
            plain_ms=device_us(cycled_pairs(lambda x, y, width=width:
                                      ref.ref_ripple_add(x, y, width)),
                               torch) / 1e3,
            library_ms=(None if library is None
                        else device_us(cycled_pairs(library), torch) / 1e3),
            library=lib_note, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, ops=nops, max_abs_err=max_abs_err(got, exp),
            shape=f"2 x ({n}, {w}) int32, w {width}")
        rows[f"ripple_add[w{width}]"] = r
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f} us ({lib_note})")
        say(f"kernel ripple_add[w{width}] {r['shape']}: kernel "
            f"{r['ms'] * 1e3:.2f} us ({r['call_ms'] * 1e3:.2f} us per call "
            f"with the host's launch), plain {r['plain_ms'] * 1e3:.2f} us, "
            f"library {lib}, bound {r['bound_ms'] * 1e3:.3f} us "
            f"({r['bound_by']}), max_abs_err {r['max_abs_err']}")

    # The kernel bench's path, ripple_add's own (the bit-plane VM records
    # PIM commands instead, as the reference's does): the fused adder at
    # w 8, the bit-plane layer's byte lanes, beside its op-by-op
    # composition, with the launch counts reset just before and read just
    # after.
    def composed_ripple_add(x, y):
        return ref.composed_ripple_add(x, y, 8, bitwise=ops.bitwise,
                                       shift_cols=ops.shift_cols)

    ops.reset_launches()
    fused = ops.ripple_add(a, b, width=8)
    composed = composed_ripple_add(a, b)
    torch.cuda.synchronize()
    bench_launches = dict(ops.LAUNCHES)
    bench_ops = dict(ops.LAUNCHES_BY_OP)
    n_composed = bench_launches["bitwise"] + bench_launches["shift_cols"]
    if not torch.equal(fused, composed) or n_composed != 2 + 4 * 7:
        raise AssertionError(f"fused ripple_add != composed ({n_composed} "
                             "launches)")
    if bench_launches["ripple_add"] == 0:
        raise AssertionError("ripple_add never launched on the kernel "
                             "bench's path")
    rec = dict(
        width=8, launches=bench_launches, by_op=bench_ops,
        composed_launches=n_composed,
        fused_ms=device_us(cycled_pairs(
            lambda x, y: ops.ripple_add(x, y, width=8)), torch) / 1e3,
        composed_ms=device_us(cycled_pairs(composed_ripple_add),
                              torch) / 1e3,
        fused_bytes=12 * n * w,
        composed_bytes=(2 * 12 + 7 * (8 + 12 + 12 + 12)) * n * w)
    say(f"fused ripple_add[w8] {n}x{w}: fused {rec['fused_ms'] * 1e3:.2f} us "
        f"== composed ({n_composed} bitwise/shift_cols launches) "
        f"{rec['composed_ms'] * 1e3:.2f} us, bit for bit; rows moved "
        f"{rec['fused_bytes'] / 2**20:.0f} MiB fused vs "
        f"{rec['composed_bytes'] / 2**20:.0f} MiB composed")
    return rows, rec


def ripple_sass():
    """Instructions per word of ``ripple_add`` at w 32 (the 16-byte-vector
    kernel), counted in ``cuobjdump -sass`` of the built library: what the
    bound's operation count rests on. A thread adds kRippleVecs vectors
    and at most one word of the tail, so the counts are divided by 4 x
    kRippleVecs + 1 words (IADD3 and IMAD include the address arithmetic).
    None where the toolkit has no ``cuobjdump``."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    vecs = int(re.search(r"constexpr int kRippleVecs = (\d+);",
                         (ROOT / SOURCES["rowops"]).read_text()).group(1))
    ops = sass_opcodes("rowops", r"ripple_add_vec4_kernelILi32E",
                       lambda m: "w32")["w32"]
    return {k: ops[k] / (4 * vecs + 1) for k in ("LOP3", "IADD3", "IMAD")}


# ---------------------------------------------------------------------------
# Phases 10-11: the bit-plane layer at the case study's sizes
# ---------------------------------------------------------------------------

def _meters(vm) -> dict:
    return {"time_ns": vm.time_ns, "energy_nj": vm.energy_nj,
            "setup_energy_nj": vm.setup_energy_nj,
            "host_overlap_ns": vm.host_overlap_ns, "counts": vm.counts()}


def _timed(torch, device, fn):
    """(result, host ms) of ``fn``, ending in a sync on the card."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _routine(name, vm, ra, rb):
    from repro_torch.core.bitplane import arith, gf
    return {"add_ripple": lambda: arith.add_ripple(vm, ra, rb),
            "add_kogge_stone": lambda: arith.add_kogge_stone(vm, ra, rb),
            "mul_shift_add": lambda: arith.mul_shift_add(vm, ra, rb),
            "xtime": lambda: gf.xtime(vm, ra),
            "gf_mul": lambda: gf.gf_mul(vm, ra, rb),
            "mixcolumns": lambda: gf.mixcolumns(vm, ra)}[name]()


def _oracle(name, a, b):
    from repro_torch.core.bitplane import arith, gf
    if name == "mixcolumns":
        return gf.ref_mixcolumns(a.reshape(-1, 4)).reshape(-1)
    return {"add_ripple": lambda: arith.ref_add(a, b, 8),
            "add_kogge_stone": lambda: arith.ref_add(a, b, 8),
            "mul_shift_add": lambda: arith.ref_mul(a, b, 8),
            "xtime": lambda: gf.ref_xtime(a),
            "gf_mul": lambda: gf.ref_gf_mul(a, b)}[name]()


def _add_step(vm, x):
    """One recurring pipeline step: load two byte-lane rows, add them."""
    from repro_torch.core.bitplane import arith
    a, b = vm.load(x[0]), vm.load(x[1])
    s = arith.add_ripple(vm, a, b)
    vm.free(a, b)
    return s


def _xtime_step(vm, x):
    from repro_torch.core.bitplane import gf
    a = vm.load(x)
    t = gf.xtime(vm, a)
    vm.free(a)
    return t


def run_bitplane(torch, device, seed=21, check_oracles=False):
    """The bit-plane path on ``device``. Returns (values, record): the
    values (reads, float32 meters, counts) phase 11 compares across
    devices, and the record of times and DDR3 model outputs. With
    ``check_oracles`` the RS encodes are also held against the numpy
    oracle (tens of seconds of host Python at these sizes)."""
    import numpy as np
    from repro_torch.core.bitplane import PimVM, layout, rs
    from repro_torch.kernels.rowops import ops

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    values, record = {}, {"routines": {}}
    for name in VM_ROUTINES:
        vm = PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, device=device)
        a = rng.integers(0, 256, vm.lanes)
        b = rng.integers(0, 256, vm.lanes)
        ra, rb = vm.load(a), vm.load(b)
        t0, e0 = vm.time_ns, vm.energy_nj
        got, host_ms = _timed(torch, device,
                              lambda: vm.read(_routine(name, vm, ra, rb)))
        if not np.array_equal(got, _oracle(name, a, b)):
            raise AssertionError(f"PimVM {name} differs from its oracle")
        values[name] = ([got], _meters(vm))
        record["routines"][name] = dict(
            host_ms=host_ms, ddr3_ns=vm.time_ns - t0,
            ddr3_nj=vm.energy_nj - e0, counts=vm.counts())
        if name == "add_ripple":
            # the fused adder (the kernel bench's form of the same add)
            # on the rows the VM loaded; its launch is this check's, not
            # the VM path's, and is counted apart
            rows = vm.state.bits
            before = ops.LAUNCHES["ripple_add"]
            fused = ops.ripple_add(rows[ra:ra + 1].contiguous(),
                                   rows[rb:rb + 1].contiguous(), width=8)
            record["check_launches"] = ops.LAUNCHES["ripple_add"] - before
            if not np.array_equal(
                    layout.unpack_elements(fused[0], 8, vm.lanes), got):
                raise AssertionError("ripple_add on the VM's rows differs "
                                     "from add_ripple's read-back row")

    # RS(12,8) on 32 banks of full rows, and on one 65,536-word subarray
    msg = rng.integers(0, 256, (RS_K, RS_WORDS * 4))
    pars, rs_rec = [], {}
    for what, banks in (("32 banks", RS_BANKS), ("one subarray", 1)):
        vm = PimVM(width=8, num_rows=RS_ROWS, words=RS_WORDS, n_banks=banks,
                   device=device)
        regs = [vm.load(msg[i]) for i in range(RS_K)]
        t0, e0 = vm.time_ns, vm.energy_nj
        par, host_ms = _timed(torch, device, lambda: np.stack(
            vm.read_many(rs.rs_encode(vm, regs, RS_NPAR))))
        pars.append(par)
        values[f"rs_encode {what}"] = ([par], _meters(vm))
        rs_rec[what] = dict(host_ms=host_ms, ddr3_ns=vm.time_ns - t0,
                            ddr3_nj=vm.energy_nj - e0)
    if not np.array_equal(pars[0], pars[1]):
        raise AssertionError("RS encode: 32 banks != one wide subarray")
    if check_oracles and not np.array_equal(
            pars[0], rs.ref_rs_encode(msg, RS_NPAR)):
        raise AssertionError("RS encode on 32 banks differs from the oracle")
    record["rs"] = rs_rec

    # the async pipeline (crypto_casestudy._async_pipeline at this size)
    lanes = PIPE_WORDS * 4
    msgs = [rng.integers(0, 256, (RS_K, lanes)) for _ in range(PIPE_CHUNKS)]
    pipe = {}
    for async_host in (False, True):
        vm = PimVM(width=8, num_rows=RS_ROWS, words=PIPE_WORDS,
                   n_banks=PIPE_BANKS, async_host=async_host, device=device)

        def encode_all(vm=vm):
            out = []
            for m in msgs:
                regs = [vm.load(m[i]) for i in range(RS_K)]
                par = rs.rs_encode(vm, regs, RS_NPAR)
                out.append(np.stack(vm.read_many(par)))
                vm.free(*regs, *par)
            return np.stack(out)

        got, host_ms = _timed(torch, device, encode_all)
        pipe[async_host] = (vm, got, host_ms)
        values[f"pipeline async={async_host}"] = ([got], _meters(vm))
    (vs, gs, ms_s), (va, ga, ms_a) = pipe[False], pipe[True]
    hidden = va.host_overlap_ns
    if check_oracles:
        for c, m in enumerate(msgs):
            if not np.array_equal(gs[c], rs.ref_rs_encode(m, RS_NPAR)):
                raise AssertionError(f"pipeline chunk {c} differs from the "
                                     "oracle")
    if not (np.array_equal(gs, ga) and vs.energy_nj == va.energy_nj
            and va.time_ns < vs.time_ns
            and abs((vs.time_ns - va.time_ns) - hidden)
            <= 1e-6 * vs.time_ns):
        raise AssertionError("async pipeline: the case study's identities "
                             "do not hold")
    record["pipeline"] = dict(sync_ns=vs.time_ns, async_ns=va.time_ns,
                              hidden_ns=hidden, energy_nj=vs.energy_nj,
                              sync_host_ms=ms_s, async_host_ms=ms_a,
                              exact=(vs.time_ns - va.time_ns) == hidden)

    # run_pipeline / run_workload on a sharded VM against step-by-step
    xs = [(rng.integers(0, 256, VM_WORDS * 4),
           rng.integers(0, 256, VM_WORDS * 4)) for _ in range(4)]
    ys = [rng.integers(0, 256, VM_WORDS * 4) for _ in range(3)]
    runs = {}
    for mode in ("run", "stepwise"):
        vm = PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, n_banks=8,
                   async_host=True, device=device)
        # every mask the steps use, created once before them: inside a
        # pipeline step a new mask would be host-written at every step
        for pattern in (0xFE, 0xFC, 0xF0, 0x7F, 0x3F, 0x0F, 0x80, 0x1B):
            vm.mask(pattern)
        if mode == "run":
            out, host_ms = _timed(torch, device, lambda: (
                vm.run_pipeline(_add_step, xs),
                vm.run_workload([(_add_step, xs[:2]), (_xtime_step, ys)])))
        else:
            def stepwise(vm=vm):
                res = []
                for fn, steps in ((_add_step, xs), (_add_step, xs[:2]),
                                  (_xtime_step, ys)):
                    out = []
                    for x in steps:
                        reg = fn(vm, x)
                        out.append(vm.read(reg))
                        vm.free(reg)
                    res.append(out)
                return res[0], res[1:]

            out, host_ms = _timed(torch, device, stepwise)
        runs[mode] = (vm, out, host_ms)
    (vr, (p, w), ms_r), (vw, (p2, w2), ms_w) = runs["run"], runs["stepwise"]
    flat = lambda o: [v for seq in o for v in seq]
    if not (all(np.array_equal(x, y) for x, y in zip(p + flat(w),
                                                      p2 + flat(w2)))
            and vr.energy_nj == vw.energy_nj and vr.counts() == vw.counts()
            and abs(vr.time_ns - vw.time_ns) <= 1e-6 * vw.time_ns):
        raise AssertionError("run_pipeline/run_workload differ from the "
                             "same steps flushed one by one")
    values["run_pipeline+run_workload"] = (p + flat(w), _meters(vr))
    record["runs"] = dict(run_host_ms=ms_r, stepwise_host_ms=ms_w,
                          run_ns=vr.time_ns, stepwise_ns=vw.time_ns)
    return values, record


def bitplane_equal(a, b) -> bool:
    """Reads equal, counts equal, float meters equal as float32 bits."""
    import numpy as np
    if a.keys() != b.keys():
        return False
    for k in a:
        (ra, ma), (rb, mb) = a[k], b[k]
        if len(ra) != len(rb) or not all(np.array_equal(x, y)
                                         for x, y in zip(ra, rb)):
            return False
        for f, x in ma.items():
            y = mb[f]
            if f == "counts":
                if x != y:
                    return False
            elif np.float32(x).view(np.uint32) != np.float32(y).view(
                    np.uint32):
                return False
    return True


def profile_vm(torch, device):
    """One warm ``mul_shift_add`` on 8 KB rows under the profiler."""
    import numpy as np
    from repro_torch.core.bitplane import PimVM, arith
    vm = PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, device=device)
    rng = np.random.default_rng(22)
    ra = vm.load(rng.integers(0, 256, vm.lanes))
    rb = vm.load(rng.integers(0, 256, vm.lanes))
    vm.read(arith.mul_shift_add(vm, ra, rb))
    return device_share(torch, lambda: vm.read(arith.mul_shift_add(vm, ra,
                                                                   rb)))


def vm_runs(torch, device, name):
    """``fn`` for launch_count: each call runs routine ``name`` on the next
    of two VMs built (8 KB rows, operands loaded) ahead of the window, and
    reads its result: one flush."""
    import numpy as np
    from repro_torch.core.bitplane import PimVM
    rng = np.random.default_rng(23)
    vms = []
    for _ in range(2):
        vm = PimVM(width=8, num_rows=VM_ROWS, words=VM_WORDS, device=device)
        vms.append((vm, vm.load(rng.integers(0, 256, vm.lanes)),
                    vm.load(rng.integers(0, 256, vm.lanes))))
    it = iter(vms)

    def fn():
        vm, ra, rb = next(it)
        return vm.read(_routine(name, vm, ra, rb))
    return fn


def say_bitplane(record):
    for name, r in record["routines"].items():
        say(f"bitplane PimVM(width=8, num_rows={VM_ROWS}, words={VM_WORDS}) "
            f"{name}: == oracle; {r['host_ms']:.2f} ms on the host clock "
            f"(card); DDR3 model {r['ddr3_ns']:.1f} ns, {r['ddr3_nj']:.1f} "
            f"nJ")
    rs_r = record["rs"]
    say(f"bitplane RS({RS_K + RS_NPAR},{RS_K}) encode, {RS_WORDS * 4} "
        f"codewords ({RS_BANKS} banks x {RS_WORDS // RS_BANKS} words x "
        f"{RS_ROWS} rows, {RS_ROWS * RS_WORDS * 4 / 2**20:.1f} MiB of "
        f"rows): == oracle == one {RS_WORDS}-word subarray; host ms "
        f"{rs_r['32 banks']['host_ms']:.1f} (32 banks), "
        f"{rs_r['one subarray']['host_ms']:.1f} (one subarray); DDR3 model "
        f"{rs_r['32 banks']['ddr3_ns']:.1f} ns vs "
        f"{rs_r['one subarray']['ddr3_ns']:.1f} ns, "
        f"{rs_r['32 banks']['ddr3_nj']:.1f} nJ")
    pp = record["pipeline"]
    say(f"bitplane async pipeline {PIPE_BANKS} banks x {PIPE_WORDS} words x "
        f"{PIPE_CHUNKS} chunks: equal bits and energy "
        f"({pp['energy_nj']:.1f} nJ); sync {pp['sync_ns']:.1f} ns - async "
        f"{pp['async_ns']:.1f} ns = hidden {pp['hidden_ns']:.1f} ns "
        f"(exact: {pp['exact']}); host ms {pp['sync_host_ms']:.1f} sync, "
        f"{pp['async_host_ms']:.1f} async")
    rr = record["runs"]
    say(f"bitplane run_pipeline + run_workload (8 banks, async) == the same "
        f"steps flushed one by one; host ms {rr['run_host_ms']:.1f} vs "
        f"{rr['stepwise_host_ms']:.1f}; DDR3 wall {rr['run_ns']:.1f} ns vs "
        f"{rr['stepwise_ns']:.1f} ns")


# ---------------------------------------------------------------------------
# Phase 13: the static verifier's gates at full width
# ---------------------------------------------------------------------------

def full_width_trace(text: str, rows: int, words: int) -> str:
    """The pim104 fixture's stream (recorded on a 16-row subarray, AAP and
    TRA only) at ``rows`` x ``words``: its reserved-tail rows (C1 and
    T0..T3, rows 10-15 there) moved to the same tail rows, so the hazard is
    the same one at the paper's geometry."""
    out = []
    for line in text.splitlines():
        if line.startswith("# pim-trace"):
            line = line.replace("rows=16 words=2",
                                f"rows={rows} words={words}")
        elif line.strip() and not line.startswith("#"):
            toks = line.split()
            line = " ".join(toks[:3] + [
                str(int(t) + rows - 16 if int(t) >= 10 else int(t))
                for t in toks[3:]])
        out.append(line)
    return "\n".join(out) + "\n"


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` (host-only work: no card)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def lint_100k_program():
    """The reference test's 100k-op stream: 100,000 AAPs between random
    rows of a 64 x 4 subarray and one seeded TRA hazard at the tail."""
    import numpy as np
    from repro_torch.core import pim
    rng = np.random.default_rng(0)
    b = pim.ProgramBuilder(64, 4)
    b.fill(pim.C0, 0)
    for src, dst in zip(rng.integers(0, 32, LINT_100K),
                        rng.integers(0, 32, LINT_100K)):
        b.rowclone(int(src), int(dst))
    b.tra(1, 1, 2)
    prog = b.build()
    prog.columns
    return prog


def phase_gates(torch, device, cfg, steps) -> dict:
    """execute(), schedule() and schedule_pipeline() with verify=True
    against verify=False on the card, bit for bit; the pim104 fixture
    refused by the gates at its own geometry and at the paper's; the host
    ms of the static tools per program, cold (their caches cleared)."""
    from repro_torch.core import pim
    from repro_torch.core.pim import lint, sem
    state = subarray_state(torch, device)
    for name, prog, refresh in subarray_programs():
        a = pim.execute(prog, state, refresh=refresh, verify=True)
        b = pim.execute(prog, state, refresh=refresh)
        if not (states_equal(torch, a.state, b.state)
                and reads_equal(torch, a.reads, b.reads)):
            raise AssertionError(f"execute({name}, verify=True) differs")
    check_device(torch, run_device(torch, device, cfg, steps, verify=True),
                 run_device(torch, device, cfg, steps))
    start = device_start(torch, device, cfg)
    a, b = (pim.schedule_pipeline(start, steps[0][0], n_steps=3,
                                  verify=verify) for verify in (True, False))
    if not (states_equal(torch, a.state.banks, b.state.banks)
            and torch.equal(a.wall_ns.view(torch.int32),
                            b.wall_ns.view(torch.int32))
            and torch.equal(a.energy_nj.view(torch.int32),
                            b.energy_nj.view(torch.int32))
            and same_reads(a.reads, b.reads)):
        raise AssertionError("schedule_pipeline(verify=True) differs")

    text = LINT_FIXTURE.read_text()
    refused = {}
    small = pim.PimProgram.from_trace(text)
    wide = pim.PimProgram.from_trace(full_width_trace(text, cfg.num_rows,
                                                      cfg.words))
    for what, fn in (
            ("execute (16 x 2)", lambda: pim.execute(
                small, verify=True, device=device)),
            ("execute (512 x 2048)", lambda: pim.execute(
                wide, state, verify=True)),
            ("schedule (64 slots)", lambda: pim.schedule(
                start, [wide] + [None] * (cfg.n_slots - 1), verify=True))):
        try:
            fn()
        except lint.LintError as e:
            refused[what] = sorted({d.code for d in e.report.errors})
        else:
            raise AssertionError(f"{what}: pim104 passed the gate")
        if "PIM104" not in refused[what]:
            raise AssertionError(f"{what}: refused without PIM104")

    def cold_lint(prog):
        lint._lint_cache.clear()
        return lint.lint_program(prog)

    def cold_sem(prog):
        sem._SEM_CACHE.clear()
        return sem.fusion_report(prog)

    per_program = {}
    for name, prog, _ in subarray_programs():
        verdict = cold_sem(prog).verdict
        if verdict != sem.EQUIVALENT:
            raise AssertionError(f"fusion of {name}: {verdict}")
        per_program[name] = {"lint_ms": host_ms(lambda: cold_lint(prog)),
                             "sem_ms": host_ms(lambda: cold_sem(prog)),
                             "fusion": verdict}
    big = lint_100k_program()
    if "PIM103" not in cold_lint(big).codes():
        raise AssertionError("100k-op lint missed its PIM103")
    shifts = pim.ProgramBuilder(64, 4).shift(0, 1, +1)
    for _ in range(LINT_100K - 1):
        shifts.shift(1, 1, +1)
    shifts = shifts.build()
    shifts.columns
    rec = {"refused": refused, "per_program": per_program,
           "lint_100k_ms": host_ms(lambda: cold_lint(big)),
           "sem_100k_ms": host_ms(
               lambda: (sem._SEM_CACHE.clear(), sem.analyze(shifts)))}
    say("gates paper_device(32, subarrays=2): execute x"
        f"{len(per_program)}, 3 schedule() steps and a 3-step "
        "schedule_pipeline with verify=True == verify=False bit for bit; "
        "pim104 refused: " + "; ".join(f"{k} {v}" for k, v in
                                       refused.items()))
    say("gates host ms per program, cold (the card machine's CPU): "
        + "; ".join(f"{k} lint {v['lint_ms']:.2f} sem {v['sem_ms']:.2f}"
                    for k, v in per_program.items())
        + f"; {LINT_100K}-op lint_program {rec['lint_100k_ms']:.1f}, "
        f"{LINT_100K}-shift sem.analyze {rec['sem_100k_ms']:.1f} (the "
        "reference's tests hold both under 1,000 ms)")
    return rec


def same_reads(a, b) -> bool:
    """Two read layouts (numpy rows, nested per step and slot) equal."""
    import numpy as np
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_reads(a[k], b[k]) for k in a))
    return len(a) == len(b) and all(same_reads(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Phase 14: the multi-tenant serving front end at full width
# ---------------------------------------------------------------------------

def front_workloads(cfg, n_steps):
    """tenant -> per-step tenant-local layouts ([bank][subarray]): six
    tenants on the serving bench's stream (write row 0, a 40-hop shift
    chain, read back), two on ``ambit_xor_program`` after host writes of
    its operand rows, each slot's data private and seeded per step."""
    import numpy as np
    from repro_torch.core import pim
    R, W, S = cfg.num_rows, cfg.words, cfg.subarrays
    rng = np.random.default_rng(23)
    stream = (pim.ProgramBuilder(R, W).issue()
              .write_row(0, np.zeros(W, np.uint32))
              .shift_k(0, 1, FRONT_SHIFT))
    stream.read_row(1)
    stream = stream.build()
    xor = pim.concat([
        pim.ProgramBuilder(R, W).write_row(0, np.zeros(W, np.uint32))
        .write_row(1, np.zeros(W, np.uint32)).build(),
        pim.ambit_xor_program(R, W)])
    out = {}
    for t in range(FRONT_TENANTS):
        base = stream if t < FRONT_STREAM_TENANTS else xor
        kind = "stream" if t < FRONT_STREAM_TENANTS else "xor"
        out[f"{kind}{t}"] = [
            [[base.with_payloads(rng.integers(
                0, 2**32, (len(base.payloads), W), dtype=np.uint32))
              for _ in range(S)] for _ in range(FRONT_BANKS)]
            for _ in range(n_steps)]
    return out


def run_front(torch, device, cfg, workloads, admission_ms=None):
    """Admit every tenant on one front on ``device`` and serve them all:
    (front, results). ``admission_ms`` collects each ``submit``'s host ms
    (shape checks, the admission lint, placement)."""
    from repro_torch.serve import pim_front
    front = pim_front.PimServeFront(cfg, device=device)
    for tid, steps in workloads.items():
        t = time.perf_counter()
        front.submit(tid, steps, banks=FRONT_BANKS)
        if admission_ms is not None:
            admission_ms.append((time.perf_counter() - t) * 1e3)
    return front, front.run()


def front_tenant_reads(results):
    """tenant -> per-step per-slot reads, across every dispatch."""
    out: dict = {}
    for res in results:
        for tid in res.placements:
            got = res.tenant_reads(tid)
            out.setdefault(tid, []).extend(got if res.n_steps > 1
                                           else [got])
    return out


def front_equal(torch, a, res_a, b, res_b) -> None:
    """Two fronts that served the same tenants: slot states, reads, tenant
    reports (float64 sums of float32 slot meters, step walls) and
    ``reconcile()`` bit for bit."""
    import numpy as np
    if not states_equal(torch, a.device.banks, b.device.banks):
        raise AssertionError("front: slot states differ")
    if not same_reads(front_tenant_reads(res_a), front_tenant_reads(res_b)):
        raise AssertionError("front: tenant reads differ")
    for tid, ra in a.reports().items():
        rb = b.report(tid)
        if (ra.busy_ns, ra.energy_nj, ra.host_bytes, ra.n_steps) != (
                rb.busy_ns, rb.energy_nj, rb.host_bytes, rb.n_steps) \
                or not np.array_equal(ra.wall_ns, rb.wall_ns):
            raise AssertionError(f"front: report of {tid} differs")
    if a.reconcile() != b.reconcile():
        raise AssertionError("front: reconcile() differs")
    if [r.coalescing for r in res_a] != [r.coalescing for r in res_b]:
        raise AssertionError("front: coalescing differs")


def phase_front(torch, device, cfg) -> tuple[dict, dict]:
    """Phase 14: eight tenants of four banks on the full device, 16 steps
    each, served by ``PimServeFront`` on the card; a hostile and an
    over-subscribing tenant refused; every tenant held to its isolated
    ``schedule()`` on the card and the front to the CPU's, every step.
    Returns (record, launches of the measured run)."""
    import numpy as np
    from repro_torch.core import pim
    from repro_torch.core.pim import lint
    from repro_torch.kernels.rowops import ops
    from repro_torch.serve import pim_front
    sched = importlib.import_module("repro_torch.core.pim.schedule")
    workloads = front_workloads(cfg, FRONT_STEPS)

    # the measured run, cold: admission (lint), plans, 16 steps
    admission_ms: list = []
    ops.reset_launches()
    d0 = sched.SCHED_STATS["dispatches"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    front, results = run_front(torch, device, cfg, workloads, admission_ms)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches = {**ops.LAUNCHES,
                **{f"bitwise_rows[{k}]": v for k, v in ops.ROWS_BY_OP.items()},
                **{f"shift_rows[{k}]": v
                   for k, v in ops.SHIFT_ROUTES.items()}}
    dispatches = sched.SCHED_STATS["dispatches"] - d0
    steps = sum(r.n_steps for r in results)
    if steps != FRONT_STEPS or front.active:
        raise AssertionError(f"front served {steps} steps")

    # the hostile tenant and the over-subscribing one, after the eight
    text = LINT_FIXTURE.read_text()
    hostile = pim.PimProgram.from_trace(full_width_trace(
        text, cfg.num_rows, cfg.words))
    live = pim_front.PimServeFront(cfg, device=device)
    for tid, steps_ in workloads.items():
        live.submit(tid, steps_, banks=FRONT_BANKS)
    refused = {}
    for tid, steps_, banks in (("hostile", (hostile, FRONT_STEPS), 1),
                               ("greedy", (workloads["stream0"][0], 1),
                                FRONT_BANKS)):
        try:
            live.submit(tid, steps_, banks=banks)
        except pim_front.AdmissionError as e:
            refused[tid] = (str(e)[:160], None if e.report is None
                            else sorted(set(e.report.codes())))
        else:
            raise AssertionError(f"tenant {tid} was admitted")
    if "PIM104" not in refused["hostile"][1] \
            or "over-subscribed" not in refused["greedy"][0]:
        raise AssertionError(f"front refusals: {refused}")

    # warm: the same tenants again, plans cached
    torch.cuda.synchronize()
    t = time.perf_counter()
    warm, warm_results = run_front(torch, device, cfg, workloads)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    front_equal(torch, front, results, warm, warm_results)
    share = device_share(torch, lambda: run_front(torch, device, cfg,
                                                  workloads))

    # the admission lint alone, cold, on each kind of tenant's layout
    lint_ms = {}
    for tid in ("stream0", f"xor{FRONT_STREAM_TENANTS}"):
        def cold(layout=workloads[tid][0]):
            lint._lint_cache.clear()
            return pim.lint_schedule(cfg.subdevice(FRONT_BANKS), layout)
        if not cold().ok:
            raise AssertionError(f"front: {tid}'s layout does not lint")
        lint_ms[tid] = host_ms(cold)

    # every tenant alone on a private 4-bank slice of the card
    reads = front_tenant_reads(results)
    for tid, steps_ in workloads.items():
        dev = pim.make_device(cfg.subdevice(FRONT_BANKS), device=device)
        iso_reads = []
        for layout in steps_:
            r = pim.schedule(dev, layout)
            dev = r.state
            iso_reads.append(r.reads)
        idx = torch.tensor(front.report(tid).slots, device=device)
        if not states_equal(torch, front.device.banks.map(lambda x: x[idx]),
                            dev.banks):
            raise AssertionError(f"front: {tid} differs from its isolated "
                                 "schedule()")
        if not same_reads(reads[tid], iso_reads):
            raise AssertionError(f"front: {tid}'s reads differ from its "
                                 "isolated schedule()")
        rep = front.report(tid)
        if (rep.busy_ns, rep.energy_nj) != (
                float(dev.slot_time_ns.cpu().numpy().astype(np.float64)
                      .sum()),
                float(dev.slot_energy_nj.cpu().numpy().astype(np.float64)
                      .sum())):
            raise AssertionError(f"front: {tid}'s meters differ from its "
                                 "isolated schedule()")
    rec_ = front.reconcile()
    for k in ("busy_ns", "energy_nj"):
        d, tn = rec_[f"device_{k}"], rec_[f"tenant_{k}"]
        if abs(d - tn) > 1e-9 * abs(d):
            raise AssertionError(f"front: reconcile {k} {d} != {tn}")

    # the card's front against the CPU's, every step
    t = time.perf_counter()
    cpu, cpu_results = run_front(torch, "cpu", cfg, workloads)
    cpu_s = time.perf_counter() - t
    front_equal(torch, front, results, cpu, cpu_results)

    walls = front.report("stream0").wall_ns     # every tenant's steps
    rec = {"tenants": FRONT_TENANTS, "banks_per_tenant": FRONT_BANKS,
           "steps": FRONT_STEPS, "cold_s": cold_s, "warm_s": warm_s,
           "steps_per_s_cold": FRONT_STEPS / cold_s,
           "steps_per_s_warm": FRONT_STEPS / warm_s,
           "dispatches": dispatches, "dispatches_per_step":
               dispatches / FRONT_STEPS,
           "coalescing": [r.coalescing for r in results],
           "groups": [r.n_groups for r in results],
           "p50_wall_ns": float(np.percentile(walls, 50)),
           "p99_wall_ns": float(np.percentile(walls, 99)),
           "admission_ms": admission_ms, "admission_lint_ms": lint_ms,
           "refused": refused,
           "reconcile": rec_, "cpu_s": cpu_s,
           "profile": share}
    say(f"front paper_device(32, subarrays=2): {FRONT_TENANTS} tenants x "
        f"{FRONT_BANKS} banks ({FRONT_STREAM_TENANTS} on the {FRONT_SHIFT}"
        f"-hop stream, {FRONT_TENANTS - FRONT_STREAM_TENANTS} on "
        f"ambit_xor), {FRONT_STEPS} steps: {dispatches} dispatches "
        f"({rec['dispatches_per_step']:.4f} per step), coalescing "
        + ", ".join(f"{c:.1f}" for c in rec["coalescing"])
        + f" ({', '.join(map(str, rec['groups']))} stream groups for "
        f"{cfg.n_slots} slots); {rec['steps_per_s_cold']:.2f} steps/s cold "
        f"(admission, plans, {FRONT_STEPS} steps: {cold_s * 1e3:.1f} ms), "
        f"{rec['steps_per_s_warm']:.2f} warm; step wall_ns (DDR3 model) "
        f"p50 {rec['p50_wall_ns']:.1f} p99 {rec['p99_wall_ns']:.1f}; host "
        "ms per admission (submit: shapes, lint once per distinct layout, "
        "placement): " + ", ".join(f"{v:.2f}" for v in admission_ms)
        + "; the admission lint alone, cold: " + ", ".join(
            f"{k} {v:.2f}" for k, v in lint_ms.items()))
    say("front refused at admission: " + "; ".join(
        f"{k}: {v[1] or v[0]}" for k, v in refused.items()))
    say(f"front == each tenant's isolated schedule() on the card for "
        f"{FRONT_TENANTS} tenants x {FRONT_STEPS} steps (reads, slot states, "
        "float32 slot meters, tenant busy/energy), reconcile "
        f"{rec_['tenant_busy_ns']:.1f} / {rec_['device_busy_ns']:.1f} ns; "
        f"front (card) == front (CPU) over all {FRONT_STEPS} steps (reads, "
        f"slot states, reports, reconcile; the CPU run {cpu_s:.1f} s)")
    say_share("front", share)
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 15: the paper's Tables 4 and 5
# ---------------------------------------------------------------------------

def phase_tables(torch, device) -> dict:
    """``shift_failure_rate`` on the card at the paper's variation levels
    (100,000 trials, normals from a seeded generator on the card) within
    the reference test's bounds of Table 4; the area model's Table 5."""
    from repro_torch.core import pim
    rates, ms = {}, {}
    for pct, (paper, bound) in TABLE4.items():
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        rate = pim.shift_failure_rate(pct, TABLE4_TRIALS, generator=gen,
                                      device=device)
        if rate.device.type != torch.device(device).type:
            raise AssertionError("shift_failure_rate left the card")
        rates[pct] = float(rate)
        if abs(rates[pct] - paper) > bound:
            raise AssertionError(f"Table 4 at {pct}%: {rates[pct]} not "
                                 f"within {bound} of {paper}")
        ms[pct] = event_us(lambda: pim.shift_failure_rate(
            pct, TABLE4_TRIALS, generator=gen, device=device), torch,
            reps=5, warmup=1) / 1e3
    area = pim.AreaModel()
    rec = {"rates": rates, "ms": ms, "overhead_pct": area.overhead_pct,
           "overhead_with_ambit_pct": area.overhead_with_ambit_pct,
           "mim_plate_side_um": pim.mim_capacitor_plate_side_um()}
    say(f"table4 shift_failure_rate ({TABLE4_TRIALS} trials on the card): "
        + "; ".join(f"{p:g}%: {rates[p]:.5f} (paper {TABLE4[p][0]}, within "
                    f"{TABLE4[p][1]}), {ms[p]:.3f} ms" for p in TABLE4))
    say(f"table5 area: migration cells {area.overhead_pct:.3f}% of a "
        f"{area.rows_per_subarray}-row subarray, "
        f"{area.overhead_with_ambit_pct:.3f}% with Ambit; MIM plate side "
        f"{rec['mim_plate_side_um']:.4f} um; "
        + "; ".join(f"{n}: {v}" for n, _, v in pim.PAPER_TABLE5))
    return rec


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

    # 2. the add latency; kernels against their plain versions
    fadd = record["fadd"] = fadd_latency(torch, device)
    kernel_rows = phase_kernels(torch, device, fadd)
    record["kernels"] = kernel_rows
    row_rows = record["row_kernels"] = phase_row_kernels(torch, device)

    # 3-4. the main path, with the launch counts reset just before it and
    # read just after it
    cfg = pim.paper_device(32, subarrays=2)
    steps = device_steps(cfg)
    ops.reset_launches()
    with FoldShapes() as folds:
        sub_results = run_subarray(torch, device)
        dev_results = run_device(torch, device, cfg, steps)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    by_op = dict(ops.ROWS_BY_OP)
    routes = dict(ops.SHIFT_ROUTES)

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

    # 5. launches over the main path: each fused segment and residual
    # SHIFT/TRA/NOT row one launch of a row entry, the old out-of-place
    # entries not at all
    say("kernels " + json.dumps({
        **launches, **{f"bitwise_rows[{k}]": v for k, v in by_op.items()},
        **{f"shift_rows[{k}]": v for k, v in routes.items()}}))
    main_path = {"shift_rows": launches["shift_rows"],
                 "bitwise_rows[maj]": by_op["maj"],
                 "bitwise_rows[not]": by_op["not"],
                 "meter_fold": launches["meter_fold"]}
    missing = [k for k, v in main_path.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if launches["shift_cols"] or launches["bitwise"]:
        raise AssertionError("the main path launched the old out-of-place "
                             "entries")
    counts = record["launch_counts"] = {
        "execute(shift_workload(1000))": launch_count(
            torch, "execute(shift_workload(1000))",
            lambda: pim.execute(pim.shift_workload_program(1000), state)),
        "execute(ambit_xor)": launch_count(
            torch, "execute(ambit_xor)",
            lambda: pim.execute(pim.ambit_xor_program(512, 2048), state)),
        "schedule() step 1": launch_count(
            torch, "schedule() step 1",
            lambda: pim.schedule(start, steps[0][0], **steps[0][1])),
    }

    # 6. the LM kernels against their plain versions
    lm_rows = phase_lm_kernels(torch, device)
    record["lm_kernels"] = lm_rows
    record["pim_routes"] = pim_routes_timed(torch, device)
    record["tc_ptxas"] = tc_ptxas()
    say("ptxas pim_matmul[tc]: " + (", ".join(
        f"{k}: {v['registers']} registers, {v['static_smem_bytes']} bytes "
        f"static smem, {v['spill_bytes']} spill bytes"
        for k, v in record["tc_ptxas"].items() if k.startswith("bits"))
        or "not measured (library not built in this process)")
        + f"; {record['tc_ptxas']['dynamic_smem_bytes']} bytes dynamic "
        "smem per block")
    record["flash_routes"] = flash_routes_timed(torch, device)
    record["flash_ptxas"] = flash_ptxas()
    say("ptxas flash_attn[split_kv]: " + ("; ".join(
        f"{k}: {v['registers']} registers, {v['spill_bytes']} spill bytes"
        for k, v in record["flash_ptxas"].items())
        or "not measured (library not built in this process)"))
    record["flash_tc_ptxas"] = flash_tc_ptxas()
    say("ptxas flash_attn[tensor_core]: " + ("; ".join(
        f"{k}: {v['registers']} registers, {v['spill_bytes']} spill bytes"
        for k, v in record["flash_tc_ptxas"].items()
        if k != "dynamic_smem_bytes")
        or "not measured (library not built in this process)")
        + "; dynamic smem per block " + ", ".join(
            f"{k} {v} bytes" for k, v in
            record["flash_tc_ptxas"]["dynamic_smem_bytes"].items()))
    spilled = {k: record["flash_tc_ptxas"][k]["spill_bytes"]
               for k in FLASH_TC_NO_SPILL if k in record["flash_tc_ptxas"]}
    if any(spilled.values()):
        raise AssertionError(f"flash tensor-core instances spill: {spilled}")
    record["tc_sass"] = tc_sass()
    say("sass pim_matmul[tc]: " + ", ".join(
        f"{k}: {v} HMMA" for k, v in sorted(record["tc_sass"].items())))
    if sorted(record["tc_sass"]) != ["bits0", "bits4", "bits8"] \
            or min(record["tc_sass"].values()) == 0:
        raise AssertionError(f"tensor-core kernel without HMMA: "
                             f"{record['tc_sass']}")
    swap_instances = [f"bits{b} mf{f}" for b in (0, 4, 8) for f in (1, 2)]
    record["swap_ptxas"] = swap_ptxas()
    say("ptxas pim_matmul[swap_ab]: " + ("; ".join(
        f"{k}: {v['registers']} registers, {v['static_smem_bytes']} bytes "
        f"static smem, {v['spill_bytes']} spill bytes"
        for k, v in sorted(record["swap_ptxas"].items()))
        or "not measured (library not built in this process)"))
    spilled = {k: v["spill_bytes"] for k, v in record["swap_ptxas"].items()
               if v["spill_bytes"]}
    if spilled:
        raise AssertionError(f"swapped-operand instances spill: {spilled}")
    record["swap_sass"] = swap_sass()
    (m, k, n), codes = PIM_SHAPES[0], PIM_SHAPES[0][1] * PIM_SHAPES[0][2]
    for key, v in record["swap_sass"].items():
        v["integer_floor_ms"] = swap_integer_floor_ms(v["per_code"], codes)
    say("sass pim_matmul[swap_ab], per weight code: " + "; ".join(
        f"{key}: {v['HMMA']} HMMA, " + ", ".join(
            f"{c:.2f} {pipe}" for pipe, c in v["per_code"].items())
        + f", integer floor {v['integer_floor_ms'] * 1e3:.2f} us at "
        f"({m},{k})@({k},{n})"
        for key, v in sorted(record["swap_sass"].items())))
    if sorted(record["swap_sass"]) != sorted(swap_instances) \
            or min(v["HMMA"] for v in record["swap_sass"].values()) == 0:
        raise AssertionError(f"swapped-operand kernel without HMMA: "
                             f"{record['swap_sass']}")
    record["flash_tc_sass"] = flash_tc_sass()
    say("sass flash_attn[tensor_core]: " + ", ".join(
        f"{k}: {v} HMMA" for k, v in sorted(record["flash_tc_sass"].items())))
    if not set(FLASH_TC_NO_SPILL) <= set(record["flash_tc_sass"]) \
            or min(record["flash_tc_sass"].values()) == 0:
        raise AssertionError(f"flash tensor-core kernel without HMMA: "
                             f"{record['flash_tc_sass']}")

    # 7. the serving path, one CUDA-graph replay per greedy_generate call,
    # with the launch counts reset just before a replayed call and read
    # just after it (inside run_serve)
    record["serve"], lm_launches, lm_routes, flash_routes = run_serve(
        torch, device)
    say("kernels serve " + json.dumps(lm_launches) + " routes "
        + json.dumps(lm_routes) + " flash routes "
        + json.dumps(flash_routes))

    # 8. card against CPU at full width, 2 layers
    record["lm_parity"] = run_lm_parity(torch, device)

    # 9. ripple_add against its plain version; fused against composed
    ripple_rows, record["fused_vs_composed"] = phase_ripple(torch, device)
    record["ripple"] = ripple_rows
    record["ripple_sass"] = ripple_sass()
    say("kernels kernel_bench " + json.dumps(
        record["fused_vs_composed"]["launches"]))
    say("sass ripple_add[w32], per word: " + (
        "not measured (no cuobjdump)" if record["ripple_sass"] is None
        else ", ".join(f"{v:g} {k}"
                       for k, v in record["ripple_sass"].items())))

    # 10. the bit-plane path, with the launch counts reset just before it
    # and read just after it
    ops.reset_launches()
    with FoldShapes() as bp_folds:
        bp_values, record["bitplane"] = run_bitplane(torch, device,
                                                     check_oracles=True)
    torch.cuda.synchronize()
    bp_launches = {**ops.LAUNCHES,
                   **{f"bitwise_rows[{k}]": v
                      for k, v in ops.ROWS_BY_OP.items()},
                   **{f"shift_rows[{k}]": v
                      for k, v in ops.SHIFT_ROUTES.items()}}
    check = record["bitplane"].pop("check_launches")
    bp_launches["ripple_add"] -= check
    say("kernels bitplane " + json.dumps(bp_launches)
        + f" (ripple_add {check} more in the check against add_ripple)")
    # The VM records PIM commands, as the reference's does, and never calls
    # ripple_add. Its shifts are chains of fewer than SHIFT_FUSE_MIN (32)
    # columns, which the compiler leaves to the residual interpreter, as
    # the reference's does: each hop is one shift_rows launch.
    missing = [k for k in ("bitwise_rows[maj]", "bitwise_rows[not]",
                           "shift_rows", "meter_fold")
               if bp_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the bit-plane "
                             f"path: {missing}")
    say_bitplane(record["bitplane"])
    record["bitplane"]["profile"] = profile_vm(torch, device)
    say_share("bitplane mul_shift_add", record["bitplane"]["profile"])
    for name in VM_ROUTINES:
        counts[name] = launch_count(torch, name, vm_runs(torch, device, name))
    say_launches(counts)
    over = {k: (v["device_ops"], BEFORE_OPS[k]) for k, v in counts.items()
            if k in VM_ROUTINES and k in BEFORE_OPS
            and 2 * v["device_ops"] > BEFORE_OPS[k]}
    if over:
        raise AssertionError(f"launches not halved: {over}")

    # 11. the same path on the CPU: reads, counts and meters identical
    t = time.perf_counter()
    cpu_values, _ = run_bitplane(torch, "cpu")
    cpu_s = time.perf_counter() - t
    if not bitplane_equal(bp_values, cpu_values):
        raise AssertionError("bit-plane path: card and CPU differ")
    say(f"bitplane parity: card == CPU for {len(bp_values)} runs (reads, "
        f"counts, float32 meters); CPU run {cpu_s:.1f} s")

    # 12. meter_fold over table sizes, up to the largest the paths folded
    largest = max((f.largest for f in (folds, bp_folds)),
                  key=lambda t: t[0].shape[0])
    say(f"fold tables on the card: {folds.calls} on the PIM path, largest "
        f"{folds.largest[0].shape[0]} rows; {bp_folds.calls} on the "
        f"bit-plane path, largest {bp_folds.largest[0].shape[0]} rows")
    record["fold_sweep"] = phase_fold_sweep(torch, device, fadd, largest)

    # 13. the verify=True gates at full width
    record["gates"] = phase_gates(torch, device, cfg, steps)

    # 14. the serving front end at full width, with the launch counts reset
    # just before its measured run and read just after it
    record["front"], front_launches = phase_front(torch, device, cfg)
    say("kernels front " + json.dumps(front_launches))
    missing = [k for k in ("shift_rows", "bitwise_rows[maj]",
                           "bitwise_rows[not]", "meter_fold")
               if front_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the front's "
                             f"path: {missing}")
    if front_launches["shift_cols"] or front_launches["bitwise"]:
        raise AssertionError("the front launched the old out-of-place "
                             "entries")
    record["front"]["launches"] = front_launches

    # 15. Tables 4 and 5
    record["tables"] = phase_tables(torch, device)

    # the row entries at the full device's 64 slots, in place (as most of
    # the main path's segments run); every shape is in chip_smoke.json
    table = []
    for name in ("shift_rows", "bitwise_rows[maj]", "bitwise_rows[not]"):
        r = row_rows[f"{name} (64, {ROW_SHAPE[0]}, {ROW_SHAPE[1]}) in place"]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES["rowops"],
            "replaces": REPLACES[name.split("[")[0]],
            "launches": main_path[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # meter_fold on the main path; the old out-of-place entries on the
    # kernel bench's composed adder (phase 9), their only path now
    bench = record["fused_vs_composed"]["launches"]
    bench_ops = record["fused_vs_composed"]["by_op"]
    for name, launched in (("meter_fold", main_path["meter_fold"]),
                           ("shift_cols", bench["shift_cols"]),
                           ("bitwise[and]", bench_ops["and"]),
                           ("bitwise[xor]", bench_ops["xor"])):
        r = kernel_rows[name]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES["rowops"],
            "replaces": REPLACES[name.split("[")[0]],
            "launches": launched, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # one row per LM kernel, at the shape of the serving path it runs at
    # (pim_matmul: decode's on the swapped operands, prefill's first on the
    # tensor cores; flash_attn: decode's split over the keys, prefill's on
    # the tensor cores); every shape is in chip_smoke.json
    (m, k, n), (pm_, pk, pn) = PIM_SHAPES[0], PIM_SHAPES[2]
    for kernel, row, launched in (
            ("pim_matmul", f"pim_matmul[shift_add,w4] ({m},{k})@({k},{n})",
             lm_routes["swap_ab"]),
            ("pim_matmul",
             f"pim_matmul[shift_add,w4] ({pm_},{pk})@({pk},{pn})",
             lm_routes["tensor_core"]),
            ("flash_attn", "flash_attn[decode]", flash_routes["split_kv"]),
            ("flash_attn", "flash_attn[prefill]",
             flash_routes["tensor_core"])):
        r = lm_rows[row]
        table.append({
            "name": row, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launched,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # ripple_add at the bit-plane layer's width (byte lanes), launched on
    # the kernel bench's path; every width is in chip_smoke.json
    r = ripple_rows["ripple_add[w8]"]
    table.append({
        "name": "ripple_add[w8]", "route": "cuda", "source": SOURCES["rowops"],
        "replaces": REPLACES["ripple_add"],
        "launches": record["fused_vs_composed"]["launches"]["ripple_add"],
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
