"""Compiled executor for recorded PIM programs.

Port of ``repro.core.pim.exec``. Lowers the fused segments of a
:class:`~.compile.CompiledProgram` onto the rowops kernels' row entries
(``shift_rows``, ``bitwise_rows``; hand-written CUDA on the card), each
ONE launch that reads its source rows of the slot state in place and
writes every destination, migration and DCC row: a k-long chain of
migration shifts (the (k-1)-column shift plus the last hop, whose
migration rows it captures), an Ambit MAJ idiom (T0, T1, T2 and dst), a
NOT pair (dst and DCC). A Python-loop interpreter runs the residual
primitives, its one-hop SHIFT, TRA and NOT-to-DCC rows on the same entries
(one launch each) and its COPY and DCC-to-row rows as one row copy each.
The meter comes from the compile-time cost tables, folded in program order
onto the incoming meter (``meter_fold`` on the card), so the final state
is bit-exact against the eager ISA: same bits, same migration/DCC side
state, same CostMeter to the last ulp.

Where the reference ``vmap``s a runner over a batch of subarrays, the port's
runner takes states with a leading slot axis ``B`` and every segment works
on row indices of the (B, R, W) state — one kernel launch covers the whole
batch. A runner clones the incoming rows once and then updates that copy in
place: the caller's state is never written.

Every state goes through the entries' wrappers, which launch the CUDA
kernels for a CUDA state and run their plain versions for a CPU state, so
``use_kernels`` (``None``: follow the device) changes nothing on the CPU,
and ``use_kernels=False`` on a CUDA state raises. ``interpret`` is
accepted for signature parity and ignored.

On the card a warm runner call is one CUDA-graph replay, the reference's
one jitted dispatch: per signature (the runner, the batch, the payload
shape) the first call runs eagerly and the second captures (``graphs``).
A pipeline runner's K steps are one graph (``lax.scan`` in the
reference), or chunks of them past ``graphs._MAX_NODES`` nodes; a workload
runner's phases run back to back in one graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import graphs, ir
from .compile import (CompiledProgram, SegHost, SegMaj, SegNot, SegScan,
                      SegShiftRun, compile_program, fold_tables,
                      xla_sum)
from .isa import T0 as isa_T0, T1 as isa_T1, T2 as isa_T2
from .state import (FLOAT_FIELDS, INT_FIELDS, CostMeter, SubarrayState,
                    as_rows, make_subarray)
from .timing import DDR3Timing, DEFAULT_TIMING, apply_refresh
from ...kernels.rowops import ops as kops


@dataclasses.dataclass
class ExecResult:
    """Final state plus host-read rows in ``read_row`` slot order."""

    state: SubarrayState
    reads: tuple


# How many runners (single-step, pipeline or workload) were built and
# CUDA graphs of the PIM path captured: the reference counts jit traces
# here. Steady-state paths must not grow it.
RUNNER_STATS = {"traces": 0}


def _as_compiled(program, cfg) -> CompiledProgram:
    """``program`` compiled, once per program object and cfg value (kept on
    the program), so that a warm ``execute`` of the same program finds its
    runner and, on the card, its graph."""
    if isinstance(program, CompiledProgram):
        return program
    cache = getattr(program, "_compiled_by_cfg", None)
    if cache is None:
        cache = {}
        object.__setattr__(program, "_compiled_by_cfg", cache)
    hit = cache.get(cfg)
    if hit is None:
        hit = cache[cfg] = compile_program(program, cfg)
    return hit


def _kernels_for(use_kernels, device: torch.device) -> bool:
    """Resolve ``use_kernels`` against the device the state lives on."""
    on_card = device.type == "cuda"
    if use_kernels is None:
        return on_card
    if on_card and not use_kernels:
        raise ValueError(
            "use_kernels=False on a CUDA state: the port runs the CUDA "
            "kernels on the card and has no plain-version path there")
    return bool(use_kernels)


# ---------------------------------------------------------------------------
# Residual-op interpreter
# ---------------------------------------------------------------------------

_SCAN_COPY, _SCAN_TRA, _SCAN_NOT2DCC, _SCAN_DCC2 = 0, 1, 2, 3
_SCAN_SHIFT_R, _SCAN_SHIFT_L = 4, 5

_SCAN_CODE = {ir.OP_ROWCLONE: _SCAN_COPY, ir.OP_DRA: _SCAN_COPY,
              ir.OP_COPY: _SCAN_COPY, ir.OP_TRA: _SCAN_TRA,
              ir.OP_NOT2DCC: _SCAN_NOT2DCC, ir.OP_DCC2: _SCAN_DCC2}


@dataclasses.dataclass(frozen=True)
class _SegTable:
    """Coalesced table of residual primitives, run by one Python loop (the
    reference's one ``lax.scan``)."""

    rows: tuple  # of (code, a, b, c)


def _op_rows(op: ir.PimOp):
    if op.op == ir.OP_SHIFT:
        code = _SCAN_SHIFT_R if op.delta > 0 else _SCAN_SHIFT_L
    else:
        code = _SCAN_CODE[op.op]
    return (code, op.a, op.b, op.c)


def _coalesce(segments):
    """Merge contiguous residual segments into single _SegTable loops. The
    reference also folds MAJ/NOT macros into its scan when kernel lowering
    is off; here they stay segments of their own, one row-entry call each."""
    out, rows = [], []

    def flush():
        if rows:
            out.append(_SegTable(rows=tuple(rows)))
            rows.clear()

    for seg in segments:
        if isinstance(seg, SegScan):
            rows.extend(_op_rows(op) for op in seg.ops)
        else:
            flush()
            out.append(seg)
    flush()
    return tuple(out)


def _table_segment(seg: _SegTable, bits, mt, mb, dcc):
    """Run one coalesced table on (B, R, W) ``bits`` in place; returns the
    new migration and DCC rows."""
    for code, a, b, c in seg.rows:
        if code == _SCAN_COPY:
            if a != b:
                bits[:, b] = bits[:, a]
        elif code == _SCAN_TRA:
            kops.bitwise_rows(bits, "maj", (a, b, c), (a, b, c))
        elif code == _SCAN_NOT2DCC:
            dcc = kops.bitwise_rows(bits, "not", (a,), side=True)
        elif code == _SCAN_DCC2:
            bits[:, b] = dcc
        else:
            mt, mb = kops.shift_rows(bits, a, b,
                                     1 if code == _SCAN_SHIFT_R else -1, 1)
    return mt, mb, dcc


# ---------------------------------------------------------------------------
# Segment walk
# ---------------------------------------------------------------------------

def _run_segments(compiled: CompiledProgram, bits, mt, mb, dcc, payloads):
    """Run the segments on a (B, R, W) slot batch, updating ``bits`` in
    place. ``payloads`` is ``(B, n_payloads, W)`` or ``(n_payloads, W)``.
    Returns ``(mt, mb, dcc, reads)`` with (B, W) read rows."""
    reads = []
    t0, t1, t2 = (t % compiled.num_rows for t in (isa_T0, isa_T1, isa_T2))
    for seg in _coalesce(compiled.segments):
        if isinstance(seg, SegShiftRun):
            # k chained 1-bit shifts in one call, the last hop's migration
            # rows captured so that mig_top/mig_bot match eager exactly
            mt, mb = kops.shift_rows(bits, seg.src, seg.dst, seg.delta,
                                     seg.k)
        elif isinstance(seg, SegMaj):
            kops.bitwise_rows(bits, "maj", (seg.a, seg.b, seg.c),
                              (t0, t1, t2, seg.dst))
        elif isinstance(seg, SegNot):
            dcc = kops.bitwise_rows(bits, "not", (seg.src,), (seg.dst,),
                                    side=True)
        elif isinstance(seg, _SegTable):
            mt, mb, dcc = _table_segment(seg, bits, mt, mb, dcc)
        elif isinstance(seg, SegHost):
            op = seg.op
            if op.op == ir.OP_READ:
                reads.append(bits[:, op.a].clone())
            elif op.op == ir.OP_WRITE:
                bits[:, op.b] = payloads[..., op.payload, :]
            elif op.op == ir.OP_FILL:
                bits[:, op.b] = int(np.uint32(op.payload).view(np.int32))
        else:
            raise TypeError(seg)
    return mt, mb, dcc, tuple(reads)


def make_runner(program, cfg: DDR3Timing = DEFAULT_TIMING, *,
                use_kernels: bool | None = None,
                interpret: bool | None = None,
                refresh: bool = False,
                payload_arg: bool = False,
                verify: bool = False):
    """Build a ``state -> ExecResult`` function for one program.

    The runner is cached per (program, flags, cfg-value). It takes one
    subarray state, or a batch with a leading slot axis, which it runs in
    one pass (one kernel launch per segment for the whole batch).

    With ``payload_arg=True`` the runner takes HOSTW payloads as a second
    argument — an ``(n_payloads, words)`` (or ``(B, n_payloads, words)``)
    int32 tensor — instead of the program's recorded payloads: the device
    scheduler's per-slot data.

    ``runner.raw(bits, mt, mb, dcc, meter, payloads)`` is the in-place
    core on a (B, R, W) batch, for the scheduler.

    ``verify=True`` statically lints the stream before building the
    runner and raises :class:`~.lint.LintError` on errors (a construction-
    time gate: cached runners are never rebuilt, so warm calls pay zero).
    """
    if verify:
        from . import lint
        src = program.program if hasattr(program, "program") else program
        report = lint.lint_program(src)
        if not report.ok:
            raise lint.LintError(report)
    compiled = _as_compiled(program, cfg)
    cache = getattr(compiled, "_runner_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(compiled, "_runner_cache", cache)
    # Key on the frozen cfg VALUE, as the reference does.
    key = (use_kernels, interpret, refresh, payload_arg, cfg)
    if key in cache:
        return cache[key]
    RUNNER_STATS["traces"] += 1
    per_device: dict = {}       # device -> (f_tab, i_tab, recorded payloads)

    def device_consts(device):
        hit = per_device.get(device)
        if hit is None:
            pays = compiled.program.payloads
            pay = (as_rows(np.stack(pays), device) if pays
                   else torch.zeros((0, compiled.words), dtype=torch.int32,
                                    device=device))
            hit = (torch.from_numpy(np.array(compiled.f_tab)).to(device),
                   torch.from_numpy(np.array(compiled.i_tab)).to(device), pay)
            per_device[device] = hit
        return hit

    def raw(bits, mt, mb, dcc, meter: CostMeter, payloads=None):
        _kernels_for(use_kernels, bits.device)    # False on the card raises
        f_tab, i_tab, recorded = device_consts(bits.device)
        mt, mb, dcc, reads = _run_segments(
            compiled, bits, mt, mb, dcc,
            recorded if payloads is None else payloads)
        f0, i0 = meter.stacked()
        ff, fi = fold_tables(f_tab, i_tab, f0.contiguous(), i0.contiguous())
        meter = CostMeter.from_stacked(ff, fi)
        if refresh:
            meter = apply_refresh(meter, cfg)
        return SubarrayState(bits=bits, mig_top=mt, mig_bot=mb, dcc=dcc,
                             meter=meter), reads

    def core(carry, payloads):
        """``raw`` on flat tensors (the graph's inputs and outputs): writes
        ``bits`` in place; the meter comes and goes as its two stacks."""
        bits, mt, mb, dcc, f0, i0 = carry
        out, reads = raw(bits, mt, mb, dcc, CostMeter.from_stacked(f0, i0),
                         payloads)
        return ((out.bits, out.mig_top, out.mig_bot, out.dcc)
                + out.meter.stacked(), reads)

    def run(state: SubarrayState, payloads=None) -> ExecResult:
        carry, single = _carry_of(state)
        if payloads is not None and single:
            payloads = payloads.unsqueeze(0)
        key = ("runner", id(run), str(state.bits.device),
               tuple(carry[0].shape),
               None if payloads is None else tuple(payloads.shape))
        carry, reads = graphs.call(key, run, core, (carry, payloads),
                                   writes=(0,))
        if single:
            reads = tuple(r.squeeze(0) for r in reads)
        return ExecResult(state=_state_of(carry, single), reads=tuple(reads))

    if payload_arg:
        def runner(state: SubarrayState, payloads) -> ExecResult:
            return run(state, payloads)
    else:
        def runner(state: SubarrayState) -> ExecResult:
            return run(state)
    runner.raw = raw
    runner.core = core
    cache[key] = runner
    return runner


def _steps_fn(core):
    """``make(n)`` for ``graphs.steps``: ``n`` calls of a runner's ``core``,
    the carry (rows written in place, meter stacks) threaded through;
    ``xs`` is the (n, n_payloads, words) payload stack, ``ys`` one (n, B,
    words) tensor per read."""
    def make(n):
        def fn(carry, xs):
            steps = []
            for k in range(n):
                carry, reads = core(carry, xs[k])
                steps.append(reads)
            return carry, tuple(torch.stack([r[j] for r in steps])
                                for j in range(len(steps[0])))
        return fn
    return make


def _carry_of(state: SubarrayState):
    """A (B, R, W) batch's runner carry, and whether ``state`` was one
    subarray (no slot axis)."""
    single = state.bits.dim() == 2
    batch = state.map(lambda t: t.unsqueeze(0)) if single else state
    return (batch.bits, batch.mig_top, batch.mig_bot, batch.dcc,
            graphs.stack_fields([getattr(batch.meter, k)
                                 for k in FLOAT_FIELDS]),
            graphs.stack_fields([getattr(batch.meter, k)
                                 for k in INT_FIELDS])), single


def _state_of(carry, single: bool) -> SubarrayState:
    bits, mt, mb, dcc, ff, fi = carry
    out = SubarrayState(bits=bits, mig_top=mt, mig_bot=mb, dcc=dcc,
                        meter=CostMeter.from_stacked(ff, fi))
    return out.map(lambda t: t.squeeze(0)) if single else out


def _reads_of(reads, single: bool, n_reads: int, state: SubarrayState):
    """Per-read (K, [B,] W) tensors; zero-step runs give (0, [B,] W)."""
    if reads is None:
        return tuple(torch.zeros((0,) + state.bits.shape[:-2]
                                 + state.bits.shape[-1:], dtype=torch.int32,
                                 device=state.bits.device)
                     for _ in range(n_reads))
    return tuple(r.squeeze(1) if single else r for r in reads)


def make_pipeline_runner(program, cfg: DDR3Timing = DEFAULT_TIMING, *,
                         use_kernels: bool | None = None,
                         interpret: bool | None = None,
                         refresh: bool = False):
    """Build a K-step pipeline ``(state, payload_steps) -> (state,
    reads_steps)`` for ONE recurring program.

    ``payload_steps`` is a ``(K, n_payloads, words)`` int32 tensor, the
    HOSTW data of each step; the same command stream runs K times, the
    state threaded through, exactly as K calls of the ``payload_arg``
    runner (the reference runs them under one ``lax.scan``; the card, as
    one CUDA-graph replay per signature). Every entry of ``reads_steps``
    carries a leading step axis. Cached per (program, flags, cfg) like
    :func:`make_runner`."""
    compiled = _as_compiled(program, cfg)
    base = make_runner(compiled, cfg, use_kernels=use_kernels,
                       interpret=interpret, refresh=refresh,
                       payload_arg=True)
    cache = compiled._runner_cache      # make_runner just ensured it exists
    key = ("pipeline", use_kernels, interpret, refresh, cfg)
    if key in cache:
        return cache[key]
    RUNNER_STATS["traces"] += 1
    n_reads = compiled.program.n_reads
    make = _steps_fn(base.core)

    def run_pipe(state: SubarrayState, payload_steps):
        n = payload_steps.shape[0]
        if n == 0:
            return state, _reads_of(None, False, n_reads, state)
        carry, single = _carry_of(state)
        carry, reads, _ = graphs.steps(
            ("pipe", id(run_pipe), str(state.bits.device),
             tuple(carry[0].shape), tuple(payload_steps.shape[1:])),
            run_pipe, make, carry, payload_steps, n)
        return _state_of(carry, single), _reads_of(reads, single, n_reads,
                                                   state)

    run_pipe.make = make
    cache[key] = run_pipe
    return run_pipe


def make_workload_runner(programs, cfg: DDR3Timing = DEFAULT_TIMING, *,
                         use_kernels: bool | None = None,
                         interpret: bool | None = None,
                         refresh: bool = False):
    """Build a MULTI-PHASE pipeline ``(state, payload_phases) -> (state,
    reads_phases)`` for a sequence of recurring programs.

    ``programs`` is one recurring program per phase; ``payload_phases`` is
    a matching tuple of ``(K_p, n_payloads_p, words)`` int32 tensors. The
    phases run back to back, each a :func:`make_pipeline_runner` loop, the
    state threaded through (on the card one graph of every phase);
    ``reads_phases`` is a tuple of per-phase read tuples, each with a
    leading step axis. Cached on the first program's compile artifact,
    keyed by the phase digest sequence."""
    compiled = [_as_compiled(p, cfg) for p in programs]
    if not compiled:
        raise ValueError("make_workload_runner needs at least one program")
    pipes = tuple(
        make_pipeline_runner(c, cfg, use_kernels=use_kernels,
                             interpret=interpret, refresh=refresh)
        for c in compiled)
    cache = compiled[0]._runner_cache   # ensured by make_pipeline_runner
    key = ("workload", tuple(c.program.digest for c in compiled),
           use_kernels, interpret, refresh, cfg)
    if key in cache:
        return cache[key]
    RUNNER_STATS["traces"] += 1
    n_reads = [c.program.n_reads for c in compiled]

    def run_workload(state: SubarrayState, payload_phases):
        payload_phases = tuple(payload_phases)
        live = [p for p, x in enumerate(payload_phases) if x.shape[0]]
        carry, single = _carry_of(state)
        dev, shape = str(state.bits.device), tuple(carry[0].shape)
        parts = [(("pipe", id(pipes[p]), dev, shape,
                   tuple(payload_phases[p].shape[1:])), pipes[p],
                  pipes[p].make, payload_phases[p],
                  payload_phases[p].shape[0]) for p in live]
        if parts:
            carry, ys, _ = graphs.phases(
                ("workload", id(run_workload), dev, shape)
                + tuple((p, tuple(payload_phases[p].shape)) for p in live),
                run_workload, parts, carry)
            state = _state_of(carry, single)
        out = dict(zip(live, ys if parts else ()))
        return state, tuple(_reads_of(out.get(p), single, n_reads[p], state)
                            for p in range(len(pipes)))

    cache[key] = run_workload
    return run_workload


def execute(program, state: SubarrayState | None = None,
            cfg: DDR3Timing = DEFAULT_TIMING, *,
            use_kernels: bool | None = None,
            interpret: bool | None = None, refresh: bool = False,
            verify: bool = False, device=None) -> ExecResult:
    """Compile (if needed) and run ``program`` against ``state`` (a fresh
    subarray on ``device`` by default: the card unless ``device="cpu"``).
    Meter increments accumulate on the incoming ``state.meter``.
    ``verify=True`` statically lints the stream first and raises
    :class:`~.lint.LintError` on errors."""
    if verify:
        from . import lint
        src = program.program if hasattr(program, "program") else program
        report = lint.lint_program(src)
        if not report.ok:
            raise lint.LintError(report)
    compiled = _as_compiled(program, cfg)
    if state is None:
        state = make_subarray(compiled.num_rows, compiled.words,
                              device=device)
    runner = make_runner(compiled, cfg, use_kernels=use_kernels,
                         interpret=interpret, refresh=refresh)
    return runner(state)


def bank_parallel(program, cfg: DDR3Timing = DEFAULT_TIMING, *,
                  use_kernels: bool | None = None,
                  interpret: bool | None = None,
                  refresh: bool = False):
    """§5.1.4 on the compiled path: ONE compiled program over a bank batch
    of states (leading slot axis). Returns ``states -> (states, wall_ns,
    energy_nj)`` — wall time is the max over banks, energy the sum."""
    runner = make_runner(program, cfg, use_kernels=use_kernels,
                         interpret=interpret, refresh=refresh)

    def wrapped(states: SubarrayState):
        out = runner(states).state
        wall_ns = torch.max(out.meter.time_ns)
        energy_nj = xla_sum(out.meter.total_energy_nj)
        return out, wall_ns, energy_nj

    return wrapped
