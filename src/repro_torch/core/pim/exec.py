"""Compiled executor for recorded PIM programs.

Port of ``repro.core.pim.exec``. Lowers the fused segments of a
:class:`~.compile.CompiledProgram` onto the rowops kernels (``shift_cols``,
``bitwise``; hand-written CUDA on the card) — a k-long chain of migration
shifts becomes ONE (k-1)-column kernel shift plus a replay of the last hop,
an Ambit MAJ idiom one ``bitwise(maj)`` call, a NOT pair one
``bitwise(not)`` call — with a Python-loop interpreter for the residual
primitives. The meter comes from the compile-time cost tables, folded in
program order onto the incoming meter (``meter_fold`` on the card), so the
final state is bit-exact against the eager ISA: same bits, same
migration/DCC side state, same CostMeter to the last ulp.

Where the reference ``vmap``s a runner over a batch of subarrays, the port's
runner takes states with a leading slot axis ``B`` and every segment works
on ``bits[:, row]`` — one kernel launch covers the whole batch. A runner
clones the incoming rows once and then updates that copy in place: the
caller's state is never written.

``use_kernels=None`` follows the device: kernels on a CUDA state, the plain
row math on a CPU state. ``use_kernels=True`` on a CPU state goes through
the kernel wrappers, which run their plain versions there;
``use_kernels=False`` on a CUDA state raises. ``interpret`` is accepted for
signature parity and ignored.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ir
from .compile import (CompiledProgram, SegHost, SegMaj, SegNot, SegScan,
                      SegShiftRun, compile_program, fold_tables,
                      sequential_sum)
from .isa import T0 as isa_T0, T1 as isa_T1, T2 as isa_T2
from .isa import lsr, maj3_words, shift_row_words
from .state import (EVEN_MASK, ODD_MASK, CostMeter, SubarrayState,
                    as_rows, make_subarray)
from .timing import DDR3Timing, DEFAULT_TIMING, apply_refresh


@dataclasses.dataclass
class ExecResult:
    """Final state plus host-read rows in ``read_row`` slot order."""

    state: SubarrayState
    reads: tuple


# How many runners were built. The reference counts jit traces here; the
# port traces nothing, so the count is of builds, and steady-state paths
# must not grow it.
RUNNER_STATS = {"traces": 0}


def _as_compiled(program, cfg) -> CompiledProgram:
    if isinstance(program, CompiledProgram):
        return program
    return compile_program(program, cfg)


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
# Row math on (B, W) slot batches
# ---------------------------------------------------------------------------

def _shift_row(row, k: int, use_kernels: bool):
    if k == 0:
        return row
    if use_kernels:
        from ...kernels.rowops import ops as kops
        return kops.shift_cols(row.contiguous(), k)
    return shift_row_words(row, k)


def _maj_rows(a, b, c, use_kernels: bool):
    if use_kernels:
        from ...kernels.rowops import ops as kops
        return kops.bitwise(a.contiguous(), b.contiguous(), c.contiguous(),
                            op="maj")
    return maj3_words(a, b, c)


def _not_row(a, use_kernels: bool):
    if use_kernels:
        from ...kernels.rowops import ops as kops
        return kops.bitwise(a.contiguous(), op="not")
    return ~a


def _shift1(row, delta: int):
    """One 1-bit shift, exactly mirroring ``shift_row_words(row, ±1)``."""
    zero = torch.zeros(row.shape[:-1] + (1,), dtype=row.dtype,
                       device=row.device)
    if delta > 0:
        carry = lsr(torch.cat([zero, row[..., :-1]], dim=-1), 31)
        return (row << 1) | carry
    carry = torch.cat([row[..., 1:], zero], dim=-1) << 31
    return lsr(row, 1) | carry


def _migrate(row, delta: int):
    """The migration rows a 1-bit shift of ``row`` captures, and the
    shifted row they merge into."""
    mt = row & (EVEN_MASK if delta > 0 else ODD_MASK)
    mb = row & (ODD_MASK if delta > 0 else EVEN_MASK)
    return mt, mb, _shift1(mt, delta) | _shift1(mb, delta)


# ---------------------------------------------------------------------------
# Residual-op interpreter
# ---------------------------------------------------------------------------

_SCAN_COPY, _SCAN_TRA, _SCAN_NOT2DCC, _SCAN_DCC2 = 0, 1, 2, 3
_SCAN_SHIFT_R, _SCAN_SHIFT_L = 4, 5
_SCAN_MAJ, _SCAN_NOTPAIR = 6, 7          # fused macro rows (SegMaj / SegNot)

_SCAN_CODE = {ir.OP_ROWCLONE: _SCAN_COPY, ir.OP_DRA: _SCAN_COPY,
              ir.OP_COPY: _SCAN_COPY, ir.OP_TRA: _SCAN_TRA,
              ir.OP_NOT2DCC: _SCAN_NOT2DCC, ir.OP_DCC2: _SCAN_DCC2}


@dataclasses.dataclass(frozen=True)
class _SegTable:
    """Coalesced table: residual primitives plus fused MAJ/NOT macro rows,
    run by one Python loop (the reference's one ``lax.scan``)."""

    rows: tuple  # of (code, a, b, c, d)


def _op_rows(op: ir.PimOp):
    if op.op == ir.OP_SHIFT:
        code = _SCAN_SHIFT_R if op.delta > 0 else _SCAN_SHIFT_L
    else:
        code = _SCAN_CODE[op.op]
    return (code, op.a, op.b, op.c, 0)


def _coalesce(segments, use_kernels):
    """With kernel lowering off, merge contiguous residual segments (incl.
    MAJ/NOT macros) into single _SegTable loops; with it on, MAJ and NOT
    stay segments of their own so that they reach the kernel."""
    out, rows = [], []

    def flush():
        if rows:
            out.append(_SegTable(rows=tuple(rows)))
            rows.clear()

    for seg in segments:
        if isinstance(seg, SegScan):
            rows.extend(_op_rows(op) for op in seg.ops)
        elif not use_kernels and isinstance(seg, SegMaj):
            rows.append((_SCAN_MAJ, seg.a, seg.b, seg.c, seg.dst))
        elif not use_kernels and isinstance(seg, SegNot):
            rows.append((_SCAN_NOTPAIR, seg.src, seg.dst, 0, 0))
        else:
            flush()
            out.append(seg)
    flush()
    return tuple(out)


def _set(bits, rows, value) -> None:
    for r in rows:
        bits[:, r] = value


def _table_segment(seg: _SegTable, bits, mt, mb, dcc, num_rows: int):
    """Run one coalesced table on (B, R, W) ``bits`` in place; returns the
    new migration and DCC rows."""
    t0, t1, t2 = (t % num_rows for t in (isa_T0, isa_T1, isa_T2))
    for code, a, b, c, d in seg.rows:
        if code == _SCAN_COPY:
            if a != b:
                bits[:, b] = bits[:, a]
        elif code == _SCAN_TRA:
            _set(bits, (a, b, c), maj3_words(bits[:, a], bits[:, b],
                                             bits[:, c]))
        elif code == _SCAN_NOT2DCC:
            dcc = ~bits[:, a]
        elif code == _SCAN_DCC2:
            bits[:, b] = dcc
        elif code in (_SCAN_SHIFT_R, _SCAN_SHIFT_L):
            mt, mb, merged = _migrate(bits[:, a],
                                      1 if code == _SCAN_SHIFT_R else -1)
            bits[:, b] = merged
        elif code == _SCAN_MAJ:
            _set(bits, (t0, t1, t2, d), maj3_words(bits[:, a], bits[:, b],
                                                   bits[:, c]))
        else:
            assert code == _SCAN_NOTPAIR, code
            dcc = ~bits[:, a]
            bits[:, b] = dcc
    return mt, mb, dcc


# ---------------------------------------------------------------------------
# Segment walk
# ---------------------------------------------------------------------------

def _run_segments(compiled: CompiledProgram, bits, mt, mb, dcc, payloads,
                  use_kernels: bool):
    """Run the segments on a (B, R, W) slot batch, updating ``bits`` in
    place. ``payloads`` is ``(B, n_payloads, W)`` or ``(n_payloads, W)``.
    Returns ``(mt, mb, dcc, reads)`` with (B, W) read rows."""
    reads = []
    for seg in _coalesce(compiled.segments, use_kernels):
        if isinstance(seg, SegShiftRun):
            # k chained 1-bit shifts: shift (k-1) columns in one kernel call,
            # then replay the last hop so mig_top/mig_bot match eager exactly.
            y = _shift_row(bits[:, seg.src], seg.delta * (seg.k - 1),
                           use_kernels)
            mt, mb, merged = _migrate(y, seg.delta)
            bits[:, seg.dst] = merged
        elif isinstance(seg, SegMaj):
            m = _maj_rows(bits[:, seg.a], bits[:, seg.b], bits[:, seg.c],
                          use_kernels)
            t0, t1, t2 = (t % compiled.num_rows
                          for t in (isa_T0, isa_T1, isa_T2))
            _set(bits, (t0, t1, t2, seg.dst), m)
        elif isinstance(seg, SegNot):
            dcc = _not_row(bits[:, seg.src], use_kernels)
            bits[:, seg.dst] = dcc
        elif isinstance(seg, _SegTable):
            mt, mb, dcc = _table_segment(seg, bits, mt, mb, dcc,
                                         compiled.num_rows)
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
    """
    if verify:
        raise NotImplementedError(
            "verify=True needs the static verifier (lint.py), which the "
            "port does not have yet (ROADMAP A8)")
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
        kernels = _kernels_for(use_kernels, bits.device)
        f_tab, i_tab, recorded = device_consts(bits.device)
        mt, mb, dcc, reads = _run_segments(
            compiled, bits, mt, mb, dcc,
            recorded if payloads is None else payloads, kernels)
        f0, i0 = meter.stacked()
        ff, fi = fold_tables(f_tab, i_tab, f0.contiguous(), i0.contiguous())
        meter = CostMeter.from_stacked(ff, fi)
        if refresh:
            meter = apply_refresh(meter, cfg)
        return SubarrayState(bits=bits, mig_top=mt, mig_bot=mb, dcc=dcc,
                             meter=meter), reads

    def run(state: SubarrayState, payloads=None) -> ExecResult:
        single = state.bits.dim() == 2
        batch = state.map(lambda t: t.unsqueeze(0)) if single else state
        if payloads is not None and single:
            payloads = payloads.unsqueeze(0)
        out, reads = raw(batch.bits.clone(), batch.mig_top, batch.mig_bot,
                         batch.dcc, batch.meter, payloads)
        if single:
            out = out.map(lambda t: t.squeeze(0))
            reads = tuple(r.squeeze(0) for r in reads)
        return ExecResult(state=out, reads=reads)

    if payload_arg:
        def runner(state: SubarrayState, payloads) -> ExecResult:
            return run(state, payloads)
    else:
        def runner(state: SubarrayState) -> ExecResult:
            return run(state)
    runner.raw = raw
    cache[key] = runner
    return runner


def execute(program, state: SubarrayState | None = None,
            cfg: DDR3Timing = DEFAULT_TIMING, *,
            use_kernels: bool | None = None,
            interpret: bool | None = None, refresh: bool = False,
            verify: bool = False, device=None) -> ExecResult:
    """Compile (if needed) and run ``program`` against ``state`` (a fresh
    subarray on ``device`` by default: the card unless ``device="cpu"``).
    Meter increments accumulate on the incoming ``state.meter``."""
    compiled = _as_compiled(program, cfg)
    if state is None:
        state = make_subarray(compiled.num_rows, compiled.words,
                              device=device)
    runner = make_runner(compiled, cfg, use_kernels=use_kernels,
                         interpret=interpret, refresh=refresh, verify=verify)
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
        energy_nj = sequential_sum(out.meter.total_energy_nj)
        return out, wall_ns, energy_nj

    return wrapped
