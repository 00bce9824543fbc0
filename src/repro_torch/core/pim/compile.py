"""Compilation passes over a recorded :class:`~.ir.PimProgram`.

Port of ``repro.core.pim.compile``; everything but the meter fold is the
reference's numpy code. Three passes:

``cost_pass``
    Replaces the eager path's per-command ``charge_*`` threading with a
    single fold. Per-charge-event float32/int32 increment tables are built
    once (numpy, exact mirrors of ``timing.charge_*``), then folded **in
    program order** onto the incoming meter — bit-exact against the eager
    meter (same IEEE adds, same order). The executor folds on the device
    with :func:`fold_tables` (the ``meter_fold`` kernel on the card).
    ``cost_summary`` is the closed-form O(1) float64 companion for planning
    (analytical, not bit-exact; cross-checked against ``estimate_cost``).

``dead_copy_elimination``
    Backward-liveness pass removing pure row overwrites (AAP/DRA copies,
    host writes, fills) whose destination is rewritten before any read.
    An *optimization*: the optimized program is cheaper by construction, so
    its meter intentionally differs from the unoptimized stream.

``fuse``
    Lowers the stream into executor segments: maximal same-direction shift
    chains become one k-column kernel shift, Ambit MAJ/NOT macro-idioms
    become single bitwise kernel calls, and residual primitives batch into
    runs for the executor's residual interpreter. Fusion is semantics-preserving (bit-exact,
    including migration-row and DCC side state); costs always come from the
    unfused stream.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import ir, isa
from .state import FLOAT_FIELDS as _FLOAT_FIELDS
from .state import INT_FIELDS as _INT_FIELDS
from .state import CostMeter, resolve_device
from .timing import (DDR3Timing, DEFAULT_TIMING, burst_time_ns,
                     refresh_events_scalar)

# ---------------------------------------------------------------------------
# Cost pass
# ---------------------------------------------------------------------------

def _event_rows(op: ir.PimOp, words: int, cfg: DDR3Timing):
    """Yield (float6, int6) increment rows for one command — one row per
    charge event, mirroring timing.charge_* float32-for-float32."""
    f32 = np.float32

    def aap(extra_shift=0):
        dt = f32(cfg.t_aap)
        return ([dt, f32(2 * cfg.e_act), f32(cfg.e_pre), 0.0, 0.0,
                 dt * f32(cfg.p_background)],
                [2, 1, 1, extra_shift, 0, 0])

    if op.op in (ir.OP_ROWCLONE, ir.OP_NOT2DCC, ir.OP_DCC2):
        yield aap()
    elif op.op == ir.OP_COPY:
        if not ir.copy_is_local(op):
            raise ValueError(
                f"cross-subarray COPY to ({op.delta}, {op.c}) cannot be "
                "compiled for one subarray — route it through the device "
                "scheduler (schedule.py), which strips and applies it")
        # timing.copy_cost(0) — a distance-0 LISA copy is exactly one AAP.
        yield aap()
    elif op.op == ir.OP_SHIFT:
        for i in range(4):                      # charge_shift = 4 × charge_aap
            yield aap(extra_shift=int(i == 3))
    elif op.op in (ir.OP_DRA, ir.OP_TRA):
        k = 2 if op.op == ir.OP_DRA else 3
        dt = f32(cfg.tRC)
        yield ([dt, f32(cfg.e_act + (k - 1) * cfg.e_act_extra_row),
                f32(cfg.e_pre), 0.0, 0.0, dt * f32(cfg.p_background)],
               [1, 1, 0, 0, int(k == 3), 0])
    elif op.op in (ir.OP_WRITE, ir.OP_READ):
        transfers = -(-(words * 4) // 64)       # charge_burst
        dt = f32(burst_time_ns(words * 4, cfg))
        yield ([dt, f32(cfg.e_act), f32(cfg.e_pre), 0.0,
                f32(transfers * cfg.e_burst_per_64b),
                dt * f32(cfg.p_background)],
               [1, 1, 0, 0, 0, 0])
    elif op.op == ir.OP_ISSUE:
        dt = f32(cfg.t_issue)
        yield ([dt, 0.0, 0.0, 0.0, 0.0, dt * f32(cfg.p_background)],
               [0, 0, 0, 0, 0, 0])
    elif op.op == ir.OP_FILL:
        return                                   # setup: meter-free
    else:
        raise ValueError(op.op)


def cost_tables_reference(program: ir.PimProgram,
                          cfg: DDR3Timing = DEFAULT_TIMING):
    """Per-op Python-loop table builder (the pre-columnar implementation).

    Kept as the bit-exactness oracle for the vectorized :func:`cost_tables`
    (differential tests compare the two row-for-row) and as the baseline
    the scheduler benchmark measures the columnar gather against."""
    frows, irows = [], []
    for op in program.ops:
        for f, i in _event_rows(op, program.words, cfg):
            frows.append(f)
            irows.append(i)
    if not frows:
        return (np.zeros((0, 6), np.float32), np.zeros((0, 6), np.int32))
    return (np.asarray(frows, np.float32), np.asarray(irows, np.int32))


# Most events any single op expands to (SHIFT = 4 AAPs).
_MAX_EVENTS = 4

# Representative op per opcode — operand-independent cost templates. COPY
# uses the local (self-slot) form; cross-slot COPYs are refused by
# cost_tables just as the per-op path refused them.
_TEMPLATE_OPS = {
    ir.OP_ISSUE: ir.PimOp(ir.OP_ISSUE),
    ir.OP_ROWCLONE: ir.PimOp(ir.OP_ROWCLONE),
    ir.OP_DRA: ir.PimOp(ir.OP_DRA),
    ir.OP_TRA: ir.PimOp(ir.OP_TRA),
    ir.OP_NOT2DCC: ir.PimOp(ir.OP_NOT2DCC),
    ir.OP_DCC2: ir.PimOp(ir.OP_DCC2),
    ir.OP_SHIFT: ir.PimOp(ir.OP_SHIFT, delta=1),
    ir.OP_WRITE: ir.PimOp(ir.OP_WRITE),
    ir.OP_READ: ir.PimOp(ir.OP_READ),
    ir.OP_FILL: ir.PimOp(ir.OP_FILL),
    ir.OP_COPY: ir.PimOp(ir.OP_COPY, delta=ir.COPY_SELF, c=ir.COPY_SELF),
}


@functools.lru_cache(maxsize=64)
def _opcode_templates(words: int, cfg: DDR3Timing):
    """Per-opcode increment templates: ``(n_codes, _MAX_EVENTS, 6)`` float32
    and int32 event rows plus the per-opcode event count, built once per
    (words, timing) through the same ``_event_rows`` generator — so the
    vectorized gather reproduces the per-op loop float32-for-float32."""
    n_codes = len(ir.OPCODES)
    f_t = np.zeros((n_codes, _MAX_EVENTS, 6), np.float32)
    i_t = np.zeros((n_codes, _MAX_EVENTS, 6), np.int32)
    counts = np.zeros(n_codes, np.int64)
    for name, op in _TEMPLATE_OPS.items():
        code = ir.OP_CODE[name]
        for e, (f, i) in enumerate(_event_rows(op, words, cfg)):
            f_t[code, e] = f
            i_t[code, e] = i
            counts[code] = e + 1
    f_t.setflags(write=False)
    i_t.setflags(write=False)
    counts.setflags(write=False)
    return f_t, i_t, counts


# Cost tables are a pure function of (op-table digest, words, timing) —
# payload data never enters the charge model — so equal streams share one
# pair of (read-only) tables across compiles. Warm multi-phase plans that
# re-compile a recurring stream (or a phase-concat of recurring streams)
# skip the gather entirely. LRU-bounded like the scheduler caches.
_cost_table_cache: dict = {}
_COST_TABLE_CACHE_MAX = 512


def cost_tables(program: ir.PimProgram,
                cfg: DDR3Timing = DEFAULT_TIMING):
    """(m, 6) float32 + (m, 6) int32 increment tables, one row per charge
    event in program order.

    Vectorized over the program's cached columnar encoding: one numpy
    gather from the per-opcode templates instead of a per-op Python loop.
    Bit-exact against :func:`cost_tables_reference` (same rows, same order,
    same float32 values). Cached per (stream digest, words, timing); the
    returned arrays are read-only."""
    cols = program.columns
    key = (cols.digest, program.words, cfg)
    hit = _cost_table_cache.pop(key, None)
    if hit is not None:
        _cost_table_cache[key] = hit    # (re)insert at the MRU end
        return hit
    codes = cols.code
    is_copy = codes.size and codes == ir.OP_CODE[ir.OP_COPY]
    if codes.size and is_copy.any():
        local = (((cols.delta == ir.COPY_SELF) & (cols.c == ir.COPY_SELF))
                 | ((cols.delta == 0) & (cols.c == 0)))
        bad = np.flatnonzero(is_copy & ~local)
        if bad.size:
            i = int(bad[0])
            raise ValueError(
                f"cross-subarray COPY to ({int(cols.delta[i])}, "
                f"{int(cols.c[i])}) cannot be compiled for one subarray — "
                "route it through the device scheduler (schedule.py), "
                "which strips and applies it")
    f_t, i_t, counts = _opcode_templates(program.words, cfg)
    ev = counts[codes] if codes.size else np.zeros(0, np.int64)
    total = int(ev.sum())
    if total == 0:
        out = (np.zeros((0, 6), np.float32), np.zeros((0, 6), np.int32))
    else:
        rep = np.repeat(codes, ev)
        within = np.arange(total) - np.repeat(np.cumsum(ev) - ev, ev)
        out = (f_t[rep, within], i_t[rep, within])
    for a in out:
        a.setflags(write=False)
    if len(_cost_table_cache) >= _COST_TABLE_CACHE_MAX:
        _cost_table_cache.pop(next(iter(_cost_table_cache)))
    _cost_table_cache[key] = out
    return out


def fold_tables(f_tab: torch.Tensor, i_tab: torch.Tensor,
                f0: torch.Tensor, i0: torch.Tensor):
    """Fold ``(m, 6)`` increment tables onto ``(B, 6)`` meter stacks, row by
    row in program order: the same float32 additions in the same order as
    the reference's ``_fold_tables`` (whose adds an optimization barrier
    keeps in order). On the card this is the ``meter_fold`` kernel; on the
    CPU ``np.add.accumulate``, exactly as :func:`cost_pass`."""
    from ...kernels.rowops import ops as kops
    return kops.meter_fold(f_tab, i_tab, f0, i0)


def sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """0-d float32 sum of a 1-d tensor, added left to right (the order the
    reference's XLA reduction takes on up to 16 slots)."""
    n = x.shape[0]
    empty = torch.zeros((n, 0), dtype=torch.int32, device=x.device)
    f, _ = fold_tables(x.reshape(n, 1).contiguous(), empty,
                       torch.zeros((1, 1), dtype=torch.float32,
                                   device=x.device),
                       torch.zeros((1, 0), dtype=torch.int32,
                                   device=x.device))
    return f[0, 0]


def cost_pass(program: ir.PimProgram, cfg: DDR3Timing = DEFAULT_TIMING,
              init: CostMeter | None = None, *, device=None) -> CostMeter:
    """Exact meter for the whole program in one fold (accumulating on top
    of ``init`` when given) — equals the eager path bit-for-bit.

    The fold is a strictly-sequential ``np.add.accumulate`` over the
    columnar increment tables on the host: the same IEEE float32 additions
    in the same order as the eager per-command path and the executor's
    fold. The meter lands on ``init``'s device, else on ``device``."""
    f_tab, i_tab = cost_tables(program, cfg)
    device = init.time_ns.device if init is not None else resolve_device(
        device)
    init = CostMeter.zeros(device) if init is None else init
    f0 = np.asarray([np.float32(getattr(init, k).item())
                     for k in _FLOAT_FIELDS], np.float32)
    i0 = np.asarray([np.int32(getattr(init, k).item())
                     for k in _INT_FIELDS], np.int32)
    if len(f_tab):
        ff = np.add.accumulate(
            np.concatenate([f0[None, :], f_tab], axis=0),
            axis=0, dtype=np.float32)[-1]
        fi = np.add.accumulate(
            np.concatenate([i0[None, :], i_tab], axis=0),
            axis=0, dtype=np.int32)[-1]
    else:
        ff, fi = f0, i0
    return CostMeter.from_stacked(
        torch.from_numpy(np.array(ff, np.float32)).to(device),
        torch.from_numpy(np.array(fi, np.int32)).to(device))


def cost_summary(program: ir.PimProgram, cfg: DDR3Timing = DEFAULT_TIMING,
                 refresh: bool = False) -> dict:
    """Closed-form float64 totals (O(ops) table build, O(1) reduction);
    analytical counterpart of ``program.estimate_cost``."""
    f_tab, i_tab = cost_tables(program, cfg)
    t, e_act, e_pre, e_ref, e_burst, e_bg = (
        f_tab.astype(np.float64).sum(axis=0) if len(f_tab) else np.zeros(6))
    counts = dict(zip(_INT_FIELDS,
                      i_tab.sum(axis=0).tolist() if len(i_tab) else [0] * 6))
    n_ref = 0
    if refresh:
        n_ref = refresh_events_scalar(t, cfg)
        t += n_ref * cfg.tRFC
        e_ref += n_ref * cfg.e_ref
        e_bg += n_ref * cfg.tRFC * cfg.p_background
        counts["n_refresh"] = n_ref
    return {
        "time_ns": float(t), "e_act": float(e_act), "e_pre": float(e_pre),
        "e_refresh": float(e_ref), "e_burst": float(e_burst),
        "e_background": float(e_bg),
        "energy_nj": float(e_act + e_pre + e_ref + e_burst + e_bg),
        **counts,
    }


# ---------------------------------------------------------------------------
# Dead-copy elimination
# ---------------------------------------------------------------------------

def dead_copy_elimination(program: ir.PimProgram,
                          live_out: set[int] | None = None) -> ir.PimProgram:
    """Drop pure overwrites (rowclone/dra/write/fill) of rows that are
    rewritten before any later read. ``live_out`` is the set of rows whose
    final contents matter; by default all rows except the Ambit scratch
    (T0..T3)."""
    if live_out is None:
        scratch = {int(t) % program.num_rows
                   for t in (isa.T0, isa.T1, isa.T2, isa.T3)}
        live_out = set(range(program.num_rows)) - scratch
    live = set(live_out)
    keep = [True] * len(program.ops)
    for i in range(len(program.ops) - 1, -1, -1):
        op = program.ops[i]
        if (op.op in (ir.OP_ROWCLONE, ir.OP_DRA, ir.OP_WRITE, ir.OP_FILL)
                and op.b not in live):
            keep[i] = False
            continue
        live -= set(op.writes())
        live |= set(op.reads())
    ops, payloads, remap = [], [], {}
    for flag, op in zip(keep, program.ops):
        if not flag:
            continue
        if op.op == ir.OP_WRITE:
            if op.payload not in remap:
                remap[op.payload] = len(payloads)
                payloads.append(program.payloads[op.payload])
            op = dataclasses.replace(op, payload=remap[op.payload])
        ops.append(op)
    return ir.PimProgram(ops=tuple(ops), num_rows=program.num_rows,
                         words=program.words, payloads=tuple(payloads))


# ---------------------------------------------------------------------------
# Fusion into executor segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegShiftRun:
    """k chained 1-bit shifts src→dst(→dst…), one direction."""
    src: int
    dst: int
    delta: int
    k: int


@dataclasses.dataclass(frozen=True)
class SegMaj:
    """Fused Ambit MAJ idiom (covers AND/OR via control rows)."""
    a: int
    b: int
    c: int
    dst: int


@dataclasses.dataclass(frozen=True)
class SegNot:
    """Fused NOT pair (not_to_dcc + dcc_to)."""
    src: int
    dst: int


@dataclasses.dataclass(frozen=True)
class SegScan:
    """Residual primitive run executed by the residual interpreter."""
    ops: tuple[ir.PimOp, ...]


@dataclasses.dataclass(frozen=True)
class SegHost:
    """Host-visible op executed unrolled (read/write/fill)."""
    op: ir.PimOp


# Residual primitives the residual interpreter understands.
_SCANNABLE = (ir.OP_ROWCLONE, ir.OP_DRA, ir.OP_TRA, ir.OP_NOT2DCC,
              ir.OP_DCC2, ir.OP_SHIFT, ir.OP_COPY)


def _maj_sites(cols: ir.ProgramColumns, num_rows: int) -> np.ndarray:
    """Boolean mask of positions ``i`` where ``ops[i:i+5]`` is the
    ambit_maj expansion in its alias-safe fused form (the vectorized
    5-op window match the old per-position ``_match_maj`` performed):
    three rowclones into T0..T2, the TRA over them, and the rowclone of
    T0 into dst — refused when a later source would have observed an
    earlier scratch write."""
    n = len(cols.table)
    maj_at = np.zeros(n, bool)
    if n < 5:
        return maj_at
    t0, t1, t2 = (int(t) % num_rows for t in (isa.T0, isa.T1, isa.T2))
    code, a, b, c = cols.code, cols.a, cols.b, cols.c
    rc, tra = ir.OP_CODE[ir.OP_ROWCLONE], ir.OP_CODE[ir.OP_TRA]
    m = ((code[:n - 4] == rc) & (b[:n - 4] == t0)
         & (code[1:n - 3] == rc) & (b[1:n - 3] == t1)
         & (code[2:n - 2] == rc) & (b[2:n - 2] == t2)
         & (code[3:n - 1] == tra) & (a[3:n - 1] == t0)
         & (b[3:n - 1] == t1) & (c[3:n - 1] == t2)
         & (code[4:] == rc) & (a[4:] == t0)
         # alias safety: reads of a, b, c precede the scratch writes
         & (a[1:n - 3] != t0) & (a[2:n - 2] != t0) & (a[2:n - 2] != t1))
    maj_at[:n - 4] = m
    return maj_at


def _shift_runs(cols: ir.ProgramColumns) -> tuple[np.ndarray, np.ndarray]:
    """Columnar chain detection: ``(cont, run_end)`` where ``cont[j]`` is
    True when the SHIFT at ``j`` continues the chain started earlier (same
    dst, src == dst, same direction) and ``run_end[s]`` holds, for every
    chain start ``s``, the index one past the chain's last op (-1
    elsewhere)."""
    n = len(cols.table)
    code, a, b, delta = cols.code, cols.a, cols.b, cols.delta
    is_shift = code == ir.OP_CODE[ir.OP_SHIFT]
    cont = np.zeros(n, bool)
    if n > 1:
        cont[1:] = (is_shift[1:] & is_shift[:-1]
                    & (a[1:] == b[1:]) & (b[1:] == b[:-1])
                    & (delta[1:] == delta[:-1]))
    run_end = np.full(n, -1, np.int64)
    starts = np.flatnonzero(is_shift & ~cont)
    if starts.size:
        breaks = np.flatnonzero(~cont)
        pos = np.searchsorted(breaks, starts, side="right")
        run_end[starts] = np.append(breaks, n)[pos]
    return cont, run_end


# Shift chains shorter than this stay residual (scan) ops: a handful of
# 1-bit hops costs less than a dedicated kernel segment, and keeping them in
# the scan table lets neighboring segments coalesce into one loop.
SHIFT_FUSE_MIN = 32


def fuse(program: ir.PimProgram, *,
         shift_fuse_min: int = SHIFT_FUSE_MIN,
         verify_semantics: bool = False) -> tuple:
    """Lower the op stream to a segment list for the executor.

    Pattern detection (MAJ idioms, shift chains) runs vectorized on the
    program's columnar encoding; the walk then just jumps between the
    precomputed match sites instead of re-inspecting ``PimOp`` operands at
    every position.

    ``verify_semantics=True`` runs the symbolic abstract interpreter
    (``sem.py``) over BOTH the op stream and the produced segment list
    and raises :class:`~.sem.EquivalenceError` unless they are proved to
    compute identical state — the opt-in proof that fusion preserved
    semantics (UNKNOWN also raises: a gate must not pass unproved)."""
    ops = program.ops
    n = len(ops)
    if n == 0:
        return ()
    cols = program.columns
    code = cols.code
    maj_at = _maj_sites(cols, program.num_rows)
    cont, run_end = _shift_runs(cols)
    shift_c = ir.OP_CODE[ir.OP_SHIFT]
    not2dcc_c, dcc2_c = ir.OP_CODE[ir.OP_NOT2DCC], ir.OP_CODE[ir.OP_DCC2]
    host_cs = {ir.OP_CODE[o] for o in (ir.OP_WRITE, ir.OP_READ, ir.OP_FILL)}
    issue_c = ir.OP_CODE[ir.OP_ISSUE]
    segments: list = []
    residual: list[ir.PimOp] = []

    def flush_residual():
        if residual:
            segments.append(SegScan(ops=tuple(residual)))
            residual.clear()

    i = 0
    while i < n:
        op = ops[i]
        ci = code[i]
        if maj_at[i]:
            flush_residual()
            segments.append(SegMaj(a=op.a, b=ops[i + 1].a, c=ops[i + 2].a,
                                   dst=ops[i + 4].b))
            i += 5
            continue
        if ci == not2dcc_c and i + 1 < n and code[i + 1] == dcc2_c:
            flush_residual()
            segments.append(SegNot(src=op.a, dst=ops[i + 1].b))
            i += 2
            continue
        if ci == shift_c:
            j = int(run_end[i])
            if j < 0:               # mid-run landing (cannot happen via the
                j = i + 1           # walk itself): extend by continuation
                while j < n and cont[j]:
                    j += 1
            if j - i >= max(2, shift_fuse_min):
                flush_residual()
                segments.append(SegShiftRun(src=op.a, dst=op.b,
                                            delta=op.delta, k=j - i))
                i = j
                continue
            residual.extend(ops[i:j])
            i = j
            continue
        if ci in host_cs:
            flush_residual()
            segments.append(SegHost(op=op))
            i += 1
            continue
        if ci == issue_c:
            i += 1                    # cost-only; no state effect
            continue
        assert op.op in _SCANNABLE, op.op
        residual.append(op)
        i += 1
    flush_residual()
    out = tuple(segments)
    if verify_semantics:
        from . import sem       # lazy: sem imports this module's dataclasses
        sem.verify_fusion(program, out)
    return out


@dataclasses.dataclass(frozen=True)
class CompiledProgram:
    """A program lowered to segments, with its cost tables prebuilt."""

    program: ir.PimProgram
    segments: tuple
    f_tab: np.ndarray
    i_tab: np.ndarray

    @property
    def num_rows(self) -> int:
        return self.program.num_rows

    @property
    def words(self) -> int:
        return self.program.words


def compile_program(program: ir.PimProgram,
                    cfg: DDR3Timing = DEFAULT_TIMING, *,
                    optimize: bool = False,
                    live_out: set[int] | None = None,
                    shift_fuse_min: int = SHIFT_FUSE_MIN,
                    verify: bool = False,
                    verify_semantics: bool = False) -> CompiledProgram:
    """Full pipeline: (optional lint) → (optional DCE) → fusion → cost
    tables.

    ``optimize=True`` applies dead-copy elimination first; the resulting
    meter reflects the *optimized* stream (cheaper than eager — that is the
    point), so equivalence tests run with the default ``optimize=False``.

    ``verify=True`` runs the static verifier (``lint.lint_program``) over
    the INPUT stream before any transformation and raises
    :class:`~.lint.LintError` on error-severity diagnostics.

    ``verify_semantics=True`` additionally proves (``sem.py``) that the
    fused segment list computes the same state as the op stream it was
    lowered from, raising :class:`~.sem.EquivalenceError` otherwise. The
    proof runs against the post-DCE stream when ``optimize=True`` (DCE
    changes dead state on purpose; the fusion gate checks fusion).
    """
    if verify:
        from . import lint      # lazy: lint imports this module's passes
        report = lint.lint_program(program)
        if not report.ok:
            raise lint.LintError(report)
    if optimize:
        program = dead_copy_elimination(program, live_out)
    f_tab, i_tab = cost_tables(program, cfg)
    return CompiledProgram(
        program=program,
        segments=fuse(program, shift_fuse_min=shift_fuse_min,
                      verify_semantics=verify_semantics),
        f_tab=f_tab, i_tab=i_tab)
