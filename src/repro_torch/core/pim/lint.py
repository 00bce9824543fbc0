"""pimlint: static verifier + hazard analyzer for PIM programs and plans.

Port of ``repro.core.pim.lint``: the same numpy analyses over the port's
copy of the columnar IR, so every diagnostic (code, op index, severity,
message, trace line) is the reference's. It runs no kernel; only the
``--workloads`` leg of the CLI records programs through the port's
``PimVM``, on ``--device``.

Every analysis here runs over the cached columnar table
(:class:`~.ir.ProgramColumns`) with a constant number of numpy passes —
O(n_ops) total, no execution, no tracing, no per-op Python loop — so a
100k-command stream lints in milliseconds and the result can be cached
per program digest and per schedule plan.

Three entry points:

``lint_program(program)``
    Single-stream hazards: operand ranges, SHIFT geometry, TRA operand
    aliasing, scratch-row clobber hazards (the early ``ambit_xor`` bug
    class), control-row clobbers, uninitialized reads, dead writes,
    host-order races, payload shape/reference errors.

``lint_schedule(cfg, programs)``
    Everything above per slot, plus cross-slot COPY hazards: destination
    coordinates outside the :class:`~.device.DeviceConfig`, two drained
    copies racing on one destination row, compute reading a row that is a
    pending copy destination, and (async plans) host-burst windows too
    large for the compute window to hide.

``lint_trace(text)`` / ``python -m repro_torch.core.pim.lint <trace>``
    The same checks over on-disk pim-trace v1/v2/v3 files, with
    line-numbered diagnostics and CI-friendly exit codes.

Diagnostics are structured (:class:`Diagnostic`) and cataloged
(:data:`CATALOG`); severities split hard contract violations (``error`` —
the executor would wrap, clobber, or race) from smells (``warning`` —
legal but almost certainly not what the program meant). ``verify=True``
gates on :class:`~.ir.ProgramBuilder`, ``compile_program``, ``execute``/
``make_runner``, and ``schedule*`` raise :class:`LintError` on errors.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from . import ir
from . import isa
from .device import (DeviceConfig, channel_occupancy, host_bus_ns,
                     issue_bus_ns)
from .state import resolve_device

__all__ = [
    "CATALOG", "Diagnostic", "LintError", "LintReport", "lint_program",
    "lint_schedule", "lint_trace", "lint_trace_file", "main",
]

ERROR = "error"
WARNING = "warning"

# code -> (default severity, title, rationale). The rationale records WHY
# the paper's geometry or the runtime's contract makes the pattern a
# hazard — DESIGN.md section 12 renders this catalog verbatim.
CATALOG: dict[str, tuple[str, str, str]] = {
    "PIM101": (ERROR, "row index out of range",
               "row operands must lie in [0, num_rows): the executor "
               "indexes the bitplane array and would silently wrap "
               "(% num_rows) onto the reserved control/scratch tail"),
    "PIM102": (ERROR, "SHIFT delta not ±1",
               "the migration cells sit at the subarray edge and move "
               "exactly one bit per activation (paper section 3); any "
               "|delta| != 1 has no hardware meaning and the cost model "
               "would mischarge it"),
    "PIM103": (ERROR, "TRA operands not distinct",
               "triple-row activation charge-shares three DISTINCT rows; "
               "duplicate operands short the same bitline twice and the "
               "majority value is undefined"),
    "PIM104": (ERROR, "scratch-row alias hazard",
               "the Ambit composites expand through T0..T3; an operand "
               "aliasing the scratch rows is clobbered mid-expansion "
               "(the early ambit_xor bug, caught at runtime then — a lint "
               "code now)"),
    "PIM105": (ERROR, "HOSTW payload mismatch",
               "a HOSTW must reference an existing payload row of shape "
               "(words,); anything else fails (or truncates) only at "
               "dispatch time"),
    "PIM106": (ERROR, "control row clobbered",
               "C0 (all-zeros) and C1 (all-ones) are the constant rows "
               "AND/OR are built from; a non-FILL write breaks every "
               "later composite that charges against them"),
    "PIM201": (WARNING, "read of uninitialized row",
               "the row is read before any HOSTW/FILL/compute write in "
               "this stream; unless device state was seeded by an "
               "earlier step the value is undefined"),
    "PIM202": (WARNING, "dead write",
               "a pure-overwrite write (AAP/DRA/HOSTW/FILL) whose row is "
               "overwritten before any read — charged DRAM activations "
               "for a value nothing observes"),
    "PIM203": (WARNING, "unread scratch row",
               "the last touch of a T0..T3 scratch row is a pure "
               "overwrite that nothing reads — usually a truncated "
               "composite expansion"),
    "PIM204": (WARNING, "host read before later compute write",
               "a HOSTR of a row that in-DRAM compute overwrites later "
               "in the same stream: the host observes an intermediate "
               "value, which is rarely the intent of a read-back"),
    "PIM205": (WARNING, "unused HOSTW payload",
               "payload rows no HOSTW references still travel with the "
               "program and inflate the identity-keyed payload caches"),
    "PIM301": (ERROR, "COPY destination outside device",
               "a cross-slot COPY names (dst_bank, dst_sub) that the "
               "DeviceConfig does not have; schedule() would reject the "
               "whole layout at dispatch time"),
    "PIM302": (ERROR, "COPY destination race",
               "two deferred copies drain into the same (slot, row) in "
               "one step; FCFS drain order decides the winner, so the "
               "result depends on stream assembly order"),
    "PIM303": (WARNING, "read of pending COPY destination",
               "a slot's compute (or HOSTR) reads a row that a cross-"
               "slot COPY writes this same step; copies drain AFTER the "
               "in-bank compute, so the read observes the pre-copy "
               "value"),
    "PIM304": (WARNING, "async host window not hidden",
               "async_host double-buffers host bursts under the previous "
               "step's compute; a per-channel burst window larger than "
               "the compute window stays on the critical path and the "
               "pipeline degenerates toward sync timing"),
    "PIM305": (ERROR, "program/device shape mismatch",
               "every slot program must share the device's "
               "(num_rows, words) subarray shape; the vmapped runners "
               "cannot batch mismatched bitplanes"),
    # PIM4xx: semantic diagnostics — findings of the symbolic abstract
    # interpreter (sem.py), proved over packed truth tables rather than
    # pattern-matched. Only emitted when the fact is PROVED (never from
    # an approximation), so every PIM4xx is a true positive.
    "PIM401": (WARNING, "op computes a constant",
               "the op's result is provably the same constant row for "
               "EVERY input (a TRA whose majority cancels its symbolic "
               "operands, or a SHIFT chain that pushes the data entirely "
               "past the subarray boundary): charged DRAM activations "
               "for a value a FILL produces free"),
    "PIM402": (WARNING, "MAJ with symbolically equal operands",
               "two TRA operand rows provably hold the same boolean "
               "function of the inputs, so MAJ degenerates to the "
               "duplicated operand — the 5-op expansion is a copy"),
    "PIM403": (WARNING, "cancelling NOT/SHIFT chain",
               "back-to-back NOTs (or a SHIFT chain returning to net "
               "displacement 0 with provably-zero edge lanes) reproduce "
               "the original value exactly; the whole chain is dead "
               "work"),
    "PIM404": (WARNING, "semantically no-op write",
               "the destination row provably already holds exactly the "
               "value being written — the activation changes nothing "
               "any program could observe"),
    "PIM405": (ERROR, "pimverify equivalence directive failed",
               "the trace carries a `# pimverify: equiv=<trace>` "
               "contract and the prover found the two programs "
               "DIFFERENT (a concrete distinguishing input exists) or "
               "could not discharge the proof"),
}

# Cap per-code emissions so a degenerate stream (every op bad) cannot
# turn the O(n) array pass into an O(n) diagnostic build.
_MAX_PER_CODE = 64

_RC = ir.OP_CODE[ir.OP_ROWCLONE]
_DRA = ir.OP_CODE[ir.OP_DRA]
_TRA = ir.OP_CODE[ir.OP_TRA]
_N2D = ir.OP_CODE[ir.OP_NOT2DCC]
_DCC2 = ir.OP_CODE[ir.OP_DCC2]
_SHIFT = ir.OP_CODE[ir.OP_SHIFT]
_WRITE = ir.OP_CODE[ir.OP_WRITE]
_READ = ir.OP_CODE[ir.OP_READ]
_FILL = ir.OP_CODE[ir.OP_FILL]
_COPY = ir.OP_CODE[ir.OP_COPY]

_READS_A = (_RC, _DRA, _N2D, _SHIFT, _READ, _COPY)
_WRITES_B = (_RC, _DRA, _DCC2, _SHIFT, _WRITE, _FILL)
# Writes that replace the row without reading it first (the
# dead_copy_elimination overwrite set): candidates for PIM202/PIM203.
_PURE_OVERWRITE = (_RC, _DRA, _WRITE, _FILL)
# In-DRAM writes (everything but HOSTW/FILL): what makes a HOSTR stale.
_COMPUTE_WRITES = (_RC, _DRA, _TRA, _DCC2, _SHIFT, _COPY)


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a catalog ``code``, its ``severity``, and the anchor —
    ``op_index`` into the stream, ``trace_line`` when the program came
    from a pim-trace file, ``slot`` = (bank, sub) device coordinates when
    found by a schedule-level pass."""

    code: str
    severity: str
    message: str
    op_index: int | None = None
    trace_line: int | None = None
    slot: tuple[int, int] | None = None

    def render(self) -> str:
        where = []
        if self.slot is not None:
            where.append(f"slot {self.slot}")
        if self.op_index is not None:
            where.append(f"op {self.op_index}")
        if self.trace_line is not None:
            where.append(f"line {self.trace_line}")
        at = f" [{', '.join(where)}]" if where else ""
        return f"{self.code} {self.severity}{at}: {self.message}"


@dataclasses.dataclass(frozen=True)
class LintReport:
    """All diagnostics of one lint pass, error-first ordering."""

    diagnostics: tuple[Diagnostic, ...] = ()

    @property
    def errors(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == ERROR)

    @property
    def warnings(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == WARNING)

    @property
    def ok(self) -> bool:
        """No errors (warnings do not fail a lint)."""
        return not self.errors

    def codes(self) -> tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)

    def render(self) -> str:
        if not self.diagnostics:
            return "clean"
        return "\n".join(d.render() for d in self.diagnostics)

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "diagnostics": [dataclasses.asdict(d) for d in self.diagnostics],
        }


class LintError(ValueError):
    """Raised by the ``verify=True`` gates when a lint finds errors."""

    def __init__(self, report: LintReport, what: str = "program"):
        self.report = report
        errs = report.errors
        head = "; ".join(d.render() for d in errs[:4])
        more = f" (+{len(errs) - 4} more)" if len(errs) > 4 else ""
        super().__init__(f"pimlint: {what} failed verification: {head}{more}")


class _Emit:
    """Diagnostic accumulator with a per-code emission cap."""

    def __init__(self):
        self.diags: list[Diagnostic] = []
        self._counts: dict[str, int] = {}

    def __call__(self, code: str, message: str, *, op_index=None,
                 severity: str | None = None) -> None:
        n = self._counts.get(code, 0)
        self._counts[code] = n + 1
        if n == _MAX_PER_CODE:
            self.diags.append(Diagnostic(
                code=code, severity=severity or CATALOG[code][0],
                message=f"further {code} diagnostics suppressed "
                        f"(> {_MAX_PER_CODE})"))
            return
        if n > _MAX_PER_CODE:
            return
        self.diags.append(Diagnostic(
            code=code, severity=severity or CATALOG[code][0],
            message=message,
            op_index=None if op_index is None else int(op_index)))


@dataclasses.dataclass(frozen=True)
class _Events:
    """Row-access events of one stream, in columnar form.

    Positions are scaled op indices — reads at ``2*i``, writes at
    ``2*i + 1`` — so an op that reads and writes the same row (e.g.
    ``AAP r r``) orders its own read before its own write."""

    r_row: np.ndarray           # read rows
    r_idx: np.ndarray           # read op indices
    r_code: np.ndarray
    w_row: np.ndarray           # write rows
    w_idx: np.ndarray
    w_code: np.ndarray
    x_row: np.ndarray           # cross-slot COPY destination rows (remote)
    x_idx: np.ndarray


def _events(cols: ir.ProgramColumns) -> _Events:
    code, a, b, c, d = cols.code, cols.a, cols.b, cols.c, cols.delta
    n = code.shape[0]
    idx = np.arange(n)
    m_tra = code == _TRA
    m_copy = code == _COPY
    local = m_copy & (((d == ir.COPY_SELF) & (c == ir.COPY_SELF))
                      | ((d == 0) & (c == 0)))
    m_ra = np.isin(code, _READS_A)
    m_wb = np.isin(code, _WRITES_B) | local
    ti = idx[m_tra]
    r_idx = np.concatenate([idx[m_ra], ti, ti, ti])
    w_idx = np.concatenate([idx[m_wb], ti, ti, ti])
    return _Events(
        r_row=np.concatenate([a[m_ra], a[m_tra], b[m_tra], c[m_tra]]),
        r_idx=r_idx, r_code=code[r_idx],
        w_row=np.concatenate([b[m_wb], a[m_tra], b[m_tra], c[m_tra]]),
        w_idx=w_idx, w_code=code[w_idx],
        x_row=b[m_copy & ~local], x_idx=idx[m_copy & ~local])


def _first_per_row(rows: np.ndarray, idxs: np.ndarray):
    """(unique rows, min op index per row) of a flagged event subset."""
    uniq, inv = np.unique(rows, return_inverse=True)
    first = np.full(uniq.shape[0], np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, inv, idxs)
    return uniq, first


def _scratch_rows(num_rows: int) -> tuple[int, ...]:
    return tuple(int(t) % num_rows for t in (isa.T0, isa.T1, isa.T2, isa.T3))


def _control_rows(num_rows: int) -> tuple[int, ...]:
    return tuple(int(t) % num_rows for t in (isa.C0, isa.C1))


def _scratch_name(r: int, num_rows: int) -> str:
    names = dict(zip(_scratch_rows(num_rows), ("T0", "T1", "T2", "T3")))
    names.update(zip(_control_rows(num_rows), ("C0", "C1")))
    return f"{names[r]} (row {r})" if r in names else f"row {r}"


def _lint_columns(cols: ir.ProgramColumns, num_rows: int, words: int,
                  payload_shapes: tuple, assume) -> tuple[Diagnostic, ...]:
    """The program-level pass: a constant number of vectorized sweeps over
    the columnar table. ``assume`` is a frozenset of rows taken as
    initialized (or the string "all")."""
    emit = _Emit()
    code, a, b, c, d = cols.code, cols.a, cols.b, cols.c, cols.delta
    p = cols.payload
    n = code.shape[0]
    ev = _events(cols)

    # --- PIM101: operand rows outside [0, num_rows) --------------------------
    all_row = np.concatenate([ev.r_row, ev.w_row, ev.x_row])
    all_idx = np.concatenate([ev.r_idx, ev.w_idx, ev.x_idx])
    bad = (all_row < 0) | (all_row >= num_rows)
    if bad.any():
        for i in np.unique(all_idx[bad])[:_MAX_PER_CODE + 1]:
            r = all_row[bad & (all_idx == i)][0]
            emit("PIM101",
                 f"row index {int(r)} out of range [0, {num_rows})",
                 op_index=i)
    r_ok = (ev.r_row >= 0) & (ev.r_row < num_rows)
    w_ok = (ev.w_row >= 0) & (ev.w_row < num_rows)
    r_row, r_idx, r_code = ev.r_row[r_ok], ev.r_idx[r_ok], ev.r_code[r_ok]
    w_row, w_idx, w_code = ev.w_row[w_ok], ev.w_idx[w_ok], ev.w_code[w_ok]

    # --- PIM102: SHIFT delta must be exactly +-1 -----------------------------
    bad = (code == _SHIFT) & ~np.isin(d, (1, -1))
    for i in np.flatnonzero(bad)[:_MAX_PER_CODE + 1]:
        emit("PIM102",
             f"SHIFT delta {int(d[i]):+d}: the migration-cell primitive "
             "moves exactly 1 bit per activation", op_index=i)

    # --- PIM103: TRA operands must be three distinct rows --------------------
    bad = (code == _TRA) & ((a == b) | (a == c) | (b == c))
    for i in np.flatnonzero(bad)[:_MAX_PER_CODE + 1]:
        emit("PIM103",
             f"TRA rows ({int(a[i])}, {int(b[i])}, {int(c[i])}) are not "
             "distinct", op_index=i)

    # --- PIM104a: MAJ-shaped window failing its alias-safety terms -----------
    # Mirrors compile._maj_sites: same 5-op structural match, but flags
    # windows where a LATER rowclone source aliases an EARLIER scratch
    # write (the conjuncts _maj_sites requires, negated).
    if n >= 5:
        t0, t1, t2, _ = _scratch_rows(num_rows)
        shape = ((code[:n - 4] == _RC) & (b[:n - 4] == t0)
                 & (code[1:n - 3] == _RC) & (b[1:n - 3] == t1)
                 & (code[2:n - 2] == _RC) & (b[2:n - 2] == t2)
                 & (code[3:n - 1] == _TRA) & (a[3:n - 1] == t0)
                 & (b[3:n - 1] == t1) & (c[3:n - 1] == t2)
                 & (code[4:] == _RC) & (a[4:] == t0))
        aliased = ((a[1:n - 3] == t0) | (a[2:n - 2] == t0)
                   | (a[2:n - 2] == t1))
        for i in np.flatnonzero(shape & aliased)[:_MAX_PER_CODE + 1]:
            emit("PIM104",
                 "MAJ expansion whose later source reads an already-"
                 "clobbered scratch row (operand aliases T0/T1)",
                 op_index=i)

    # --- PIM104b: stale scratch read (the early ambit_xor hazard) -----------
    # A read of T0/T1/T2 whose last writer is a TRA further back than the
    # immediately following op: the one legitimate consumer of a TRA
    # result is the very next rowclone-out of the MAJ expansion; anything
    # later means the caller handed scratch rows to a composite that
    # already destroyed them.
    t_rows = _scratch_rows(num_rows)[:3]
    for r in t_rows:
        wp = w_idx[w_row == r]
        if not wp.size:
            continue
        order = np.argsort(wp, kind="stable")
        wp = wp[order]
        wc = w_code[w_row == r][order]
        rp = r_idx[r_row == r]
        j = np.searchsorted(wp, rp, side="left") - 1
        ok = j >= 0
        stale = ok & (wc[np.maximum(j, 0)] == _TRA) \
            & (rp > wp[np.maximum(j, 0)] + 1)
        for i in np.unique(rp[stale])[:_MAX_PER_CODE + 1]:
            emit("PIM104",
                 f"reads scratch {_scratch_name(r, num_rows)} last "
                 "written by a TRA more than one op earlier — the "
                 "operand aliased a composite's T0..T3 scratch and was "
                 "clobbered mid-expansion", op_index=i)

    # --- PIM105 / PIM205: HOSTW payload references ---------------------------
    m_w = code == _WRITE
    pay = p[m_w]
    w_ops = np.flatnonzero(m_w)
    n_pay = len(payload_shapes)
    bad = (pay < 0) | (pay >= n_pay)
    for i, k in zip(w_ops[bad][:_MAX_PER_CODE + 1], pay[bad]):
        emit("PIM105",
             f"HOSTW references payload {int(k)} but the program has "
             f"{n_pay}", op_index=i)
    for k, shape in enumerate(payload_shapes):
        if shape != (words,):
            hits = w_ops[pay == k]
            emit("PIM105",
                 f"payload {k} has shape {tuple(shape)}, subarray rows "
                 f"are ({words},)",
                 op_index=hits[0] if hits.size else None)
    if n_pay:
        unused = sorted(set(range(n_pay)) - set(pay[~bad].tolist()))
        if unused:
            head = ", ".join(map(str, unused[:8]))
            more = "..." if len(unused) > 8 else ""
            emit("PIM205",
                 f"{len(unused)} payload row(s) never referenced by any "
                 f"HOSTW: [{head}{more}]")

    # --- PIM106: non-FILL write to a control row -----------------------------
    for r in _control_rows(num_rows):
        clob = np.flatnonzero((w_row == r) & (w_code != _FILL))
        if not clob.size:
            continue
        fills = np.sort(w_idx[(w_row == r) & (w_code == _FILL)])
        reads = np.sort(r_idx[r_row == r])
        for i in np.unique(w_idx[clob])[:_MAX_PER_CODE + 1]:
            nf = np.searchsorted(fills, i, side="right")
            until = fills[nf] if nf < fills.size else np.iinfo(np.int64).max
            k = np.searchsorted(reads, i, side="right")
            read_back = k < reads.size and reads[k] < until
            emit("PIM106",
                 f"{_scratch_name(r, num_rows)} clobbered by a non-FILL "
                 "write" + (" and read again before any re-FILL"
                            if read_back else
                            " (never read after — downgrade to warning)"),
                 op_index=i,
                 severity=ERROR if read_back else WARNING)

    # --- PIM201: reads before any write ("all" skips: prior-step state) ------
    if assume != "all":
        first_w = np.full(num_rows, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first_w, w_row, 2 * w_idx + 1)
        keep = np.ones(num_rows, bool)
        for r in assume:
            if 0 <= r < num_rows:
                keep[r] = False
        un = keep[r_row] & (2 * r_idx < first_w[r_row])
        if un.any():
            rows_u, first_u = _first_per_row(r_row[un], r_idx[un])
            for r, i in zip(rows_u[:_MAX_PER_CODE + 1], first_u):
                emit("PIM201",
                     f"row {int(r)} read before any write in this stream",
                     op_index=i)
        # The DCC register variant: DCC2 copies the dual-contact cell out,
        # which only NOT2DCC loads.
        d2 = np.flatnonzero(code == _DCC2)
        n2 = np.flatnonzero(code == _N2D)
        first_n2 = n2[0] if n2.size else np.iinfo(np.int64).max
        if d2.size and d2[0] < first_n2:
            emit("PIM201",
                 "DCC2 before any NOT2DCC: the dual-contact cell was "
                 "never loaded", op_index=d2[0])

    # --- PIM202/PIM203: dead writes and unread scratch -----------------------
    ev_row = np.concatenate([r_row, w_row])
    ev_pos = np.concatenate([2 * r_idx, 2 * w_idx + 1])
    ev_isw = np.concatenate([np.zeros(r_row.shape[0], bool),
                             np.ones(w_row.shape[0], bool)])
    ev_code = np.concatenate([r_code, w_code])
    ev_opi = np.concatenate([r_idx, w_idx])
    order = np.lexsort((ev_pos, ev_row))
    row_s = ev_row[order]
    isw_s = ev_isw[order]
    code_s = ev_code[order]
    opi_s = ev_opi[order]
    pure_s = isw_s & np.isin(code_s, _PURE_OVERWRITE)
    if row_s.size:
        same_next = np.zeros(row_s.shape[0], bool)
        same_next[:-1] = row_s[1:] == row_s[:-1]
        dead = pure_s & same_next
        dead[:-1] &= isw_s[1:]
        for k in np.flatnonzero(dead)[:_MAX_PER_CODE + 1]:
            emit("PIM202",
                 f"write to row {int(row_s[k])} is overwritten (op "
                 f"{int(opi_s[k + 1])}) before any read",
                 op_index=opi_s[k])
        last = ~same_next   # last event of each row group
        scr = np.isin(row_s, _scratch_rows(num_rows))
        for k in np.flatnonzero(last & pure_s & scr)[:_MAX_PER_CODE + 1]:
            emit("PIM203",
                 f"scratch {_scratch_name(int(row_s[k]), num_rows)} "
                 "written but never read afterwards — truncated composite "
                 "expansion?", op_index=opi_s[k])

    # --- PIM204: HOSTR of a row that compute later overwrites ----------------
    hostr = r_code == _READ
    if hostr.any():
        cw = np.isin(w_code, _COMPUTE_WRITES)
        last_cw = np.full(num_rows, -1, np.int64)
        np.maximum.at(last_cw, w_row[cw], 2 * w_idx[cw] + 1)
        stale = hostr & (last_cw[r_row] > 2 * r_idx)
        if stale.any():
            rows_u, first_u = _first_per_row(r_row[stale], r_idx[stale])
            for r, i in zip(rows_u[:_MAX_PER_CODE + 1], first_u):
                emit("PIM204",
                     f"HOSTR of row {int(r)} precedes an in-DRAM write of "
                     "the same row: the host reads an intermediate value",
                     op_index=i)

    return tuple(emit.diags)


# ---------------------------------------------------------------------------
# Program-level entry point (digest-keyed cache)
# ---------------------------------------------------------------------------

_lint_cache: dict = {}
_LINT_CACHE_MAX = 512


def _assume_key(assume_initialized, num_rows: int):
    if assume_initialized == "all":
        return "all"
    if assume_initialized is None:
        return frozenset(_control_rows(num_rows))
    return frozenset(int(r) % num_rows for r in assume_initialized)


def _semantic_diags(program: ir.PimProgram) -> tuple[Diagnostic, ...]:
    """The PIM401-404 tier: findings of the symbolic abstract interpreter
    (``sem.semantic_findings``, content-digest-cached there). Best-effort
    — a stream the interpreter cannot model yields no semantic findings;
    the structural tier above owns malformed programs."""
    from . import sem      # lazy: keep non-semantic lints numpy-light
    findings = sem.semantic_findings(program)
    return tuple(Diagnostic(code=code, severity=CATALOG[code][0],
                            message=msg, op_index=opi)
                 for code, opi, msg in findings)


def lint_program(program: ir.PimProgram, *, assume_initialized=None,
                 semantic: bool = False) -> LintReport:
    """Statically verify one command stream. Pure columnar analysis: no
    execution, no tracing, cached per (digest, shape, payload shapes).

    ``assume_initialized`` — rows exempt from the PIM201 uninitialized-
    read check: ``None`` (default) exempts only C0/C1 (pre-seeded by
    ``make_device``/``reserve_control_rows`` outside the stream), a row
    iterable exempts those rows, and ``"all"`` disables the check (the
    right setting when device state persists from earlier steps, e.g.
    inside a schedule plan).

    ``semantic=True`` additionally runs the PIM4xx tier (``sem.py``):
    proved constant results, degenerate MAJs, cancelling NOT/SHIFT
    chains, no-op writes. Off by default — the verify gates and hot
    schedule paths stay structural-only; ``lint_trace``/the CLI turn it
    on."""
    assume = _assume_key(assume_initialized, program.num_rows)
    shapes = tuple(tuple(p.shape) for p in program.payloads)
    key = (program.digest, program.num_rows, program.words, shapes, assume)
    diags = _lint_cache.pop(key, None)
    if diags is None:
        diags = _lint_columns(program.columns, program.num_rows,
                              program.words, shapes, assume)
        diags = tuple(sorted(
            diags, key=lambda d: (d.severity != ERROR,
                                  d.op_index if d.op_index is not None
                                  else 1 << 60, d.code)))
        if len(_lint_cache) >= _LINT_CACHE_MAX:
            _lint_cache.pop(next(iter(_lint_cache)))
    _lint_cache[key] = diags
    if semantic:
        # Semantic findings ride sem.py's own payload-CONTENT-keyed cache
        # (HOSTW bits are constants in the truth-table domain, so the
        # shapes-keyed structural cache above must not hold them).
        diags = tuple(sorted(
            diags + _semantic_diags(program),
            key=lambda d: (d.severity != ERROR,
                           d.op_index if d.op_index is not None
                           else 1 << 60, d.code)))
    lines = program.trace_lines
    if lines:
        diags = tuple(
            dataclasses.replace(d, trace_line=lines[d.op_index])
            if d.op_index is not None and d.op_index < len(lines) else d
            for d in diags)
    return LintReport(diagnostics=diags)


# ---------------------------------------------------------------------------
# Schedule-level analyses
# ---------------------------------------------------------------------------

def _copy_hazard_diags(cfg: DeviceConfig, slot_programs,
                       deferred) -> list[Diagnostic]:
    """PIM302/PIM303 over a resolved deferred-copy list
    ``[(src_slot, dst_slot, op), ...]`` (the scheduler's own shape); a
    4th/5th tuple element (op index, trace line) adds source provenance
    when the caller has it."""
    diags: list[Diagnostic] = []
    seen: dict[tuple[int, int], int] = {}
    for item in deferred:
        s, dd, op = item[0], item[1], item[2]
        opi = item[3] if len(item) > 3 else None
        tline = item[4] if len(item) > 4 else None
        dst = (dd, op.b)
        if dst in seen:
            diags.append(Diagnostic(
                code="PIM302", severity=ERROR,
                slot=cfg.slot_coords(s), op_index=opi, trace_line=tline,
                message=f"COPY into slot {cfg.slot_coords(dd)} row "
                        f"{op.b} races an earlier copy from slot "
                        f"{cfg.slot_coords(seen[dst])} this step"))
        else:
            seen[dst] = s
    if not seen:
        return diags
    reads: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for (dd, row), s in seen.items():
        prog = slot_programs[dd] if dd < len(slot_programs) else None
        if prog is None or not len(prog.ops):
            continue
        if dd not in reads:
            ev = _events(prog.columns)
            reads[dd] = (ev.r_row, ev.r_idx)
        r_row, r_idx = reads[dd]
        hits = r_idx[r_row == row]
        if hits.size:
            first = int(hits.min())
            diags.append(Diagnostic(
                code="PIM303", severity=WARNING,
                slot=cfg.slot_coords(dd), op_index=first,
                trace_line=(prog.trace_lines[first]
                            if prog.trace_lines else None),
                message=f"slot {cfg.slot_coords(dd)} reads row {row} "
                        f"which a COPY from slot {cfg.slot_coords(s)} "
                        "overwrites this step; copies drain after "
                        "compute, so the read sees the pre-copy value"))
    return diags


def _async_hide_diags(cfg: DeviceConfig, slot_programs) -> list[Diagnostic]:
    """PIM304: per-channel host-burst occupancy vs the compute window the
    async credit could at best hide it under."""
    from .compile import cost_summary    # lazy: compile is heavier
    t = cfg.timing
    issue = np.zeros(cfg.n_slots, np.float32)
    host = np.zeros(cfg.n_slots, np.float32)
    compute = 0.0
    summaries: dict[bytes, tuple] = {}
    for k, prog in enumerate(slot_programs):
        if prog is None or not len(prog.ops):
            continue
        hit = summaries.get(prog.digest)
        if hit is None:
            ib = issue_bus_ns(prog, t)
            hb = host_bus_ns(prog, t)
            cs = cost_summary(prog, t)["time_ns"]
            hit = summaries[prog.digest] = (ib, hb, cs)
        ib, hb, cs = hit
        issue[k] = ib
        host[k] = hb
        compute = max(compute, cs - ib - hb)
    if not host.any():
        return []
    _, host_ch, _ = channel_occupancy(cfg, issue, host)
    worst = int(np.argmax(host_ch))
    if float(host_ch[worst]) <= compute:
        return []
    return [Diagnostic(
        code="PIM304", severity=WARNING,
        message=f"channel {worst}'s host bursts occupy "
                f"{float(host_ch[worst]):.0f} ns but the step computes "
                f"for ~{compute:.0f} ns: async_host cannot fully hide "
                "the transfers and the excess stays on the wall clock")]


def _plan_diagnostics(cfg: DeviceConfig, stripped, groups, deferred,
                      async_host: bool) -> tuple[Diagnostic, ...]:
    """Diagnostics of one lowered schedule layout — called ONCE per
    step-plan build (``schedule._plan_for``) and stored on the cached
    ``_StepPlan``, so warm paths pay nothing. Uninitialized-read checks
    are disabled (device state persists across steps)."""
    diags: list[Diagnostic] = []
    for key, slot_ids in groups.items():
        rep = stripped[slot_ids[0]]
        rep_report = lint_program(rep, assume_initialized="all")
        coords = cfg.slot_coords(slot_ids[0])
        diags.extend(dataclasses.replace(d, slot=coords)
                     for d in rep_report.diagnostics)
    diags.extend(_copy_hazard_diags(cfg, stripped, deferred))
    if async_host:
        diags.extend(_async_hide_diags(cfg, stripped))
    return tuple(diags)


def lint_schedule(cfg: DeviceConfig, programs, *,
                  async_host: bool = False,
                  semantic: bool = False) -> LintReport:
    """Statically verify a whole schedule layout against ``cfg``: the
    program-level pass per distinct stream plus the cross-slot COPY and
    async-host analyses. Accepts every layout ``schedule()`` accepts, and
    DIAGNOSES (rather than raises on) shape mismatches and out-of-device
    COPY destinations. ``semantic=True`` adds the PIM4xx tier per
    distinct stream (distinct by payload CONTENT, not just shape — HOSTW
    bits are constants in the semantic domain)."""
    from .schedule import _normalize_programs    # lazy: avoid cycle
    emit: list[Diagnostic] = []
    try:
        flat = _normalize_programs(cfg, programs)
    except (ValueError, AssertionError) as e:
        return LintReport((Diagnostic(code="PIM305", severity=ERROR,
                                      message=str(e)),))

    seen: set = set()
    deferred: list = []
    for k, prog in enumerate(flat):
        if prog is None:
            continue
        coords = cfg.slot_coords(k)
        if (prog.num_rows, prog.words) != (cfg.num_rows, cfg.words):
            emit.append(Diagnostic(
                code="PIM305", severity=ERROR, slot=coords,
                message=f"program shape {(prog.num_rows, prog.words)} != "
                        f"device shape {(cfg.num_rows, cfg.words)}"))
            continue
        key = (prog.digest, tuple(tuple(p.shape) for p in prog.payloads))
        if semantic:
            key = key + (prog.payload_digest,)
        if key not in seen:
            seen.add(key)
            emit.extend(dataclasses.replace(d, slot=coords)
                        for d in lint_program(
                            prog, semantic=semantic).diagnostics)
        # Resolve cross-slot copies, diagnosing bad coordinates (PIM301)
        # where the scheduler's _split_copies would raise.
        for i, op in enumerate(prog.ops):
            if op.op != ir.OP_COPY or ir.copy_is_local(op):
                continue
            try:
                dst_slot = cfg.slot_index(op.delta, op.c)
            except ValueError:
                emit.append(Diagnostic(
                    code="PIM301", severity=ERROR, slot=coords, op_index=i,
                    trace_line=(prog.trace_lines[i]
                                if prog.trace_lines else None),
                    message=f"COPY destination ({op.delta}, {op.c}) "
                            f"outside the device ({cfg.n_banks} banks x "
                            f"{cfg.subarrays} subarrays)"))
                continue
            if dst_slot != k:
                deferred.append((k, dst_slot, op, i,
                                 prog.trace_lines[i]
                                 if prog.trace_lines else None))
    emit.extend(_copy_hazard_diags(cfg, flat, deferred))
    if async_host:
        emit.extend(_async_hide_diags(cfg, flat))
    emit.sort(key=lambda dg: (dg.severity != ERROR,
                              dg.slot if dg.slot is not None else (-1, -1),
                              dg.op_index if dg.op_index is not None
                              else 1 << 60, dg.code))
    return LintReport(tuple(emit))


def lint_trace(text: str, *, banks: int | None = None,
               subarrays: int | None = None,
               async_host: bool = False,
               semantic: bool = True) -> LintReport:
    """Lint a pim-trace v1/v2/v3 text. The device defaults to the trace
    header's geometry on one channel/rank; ``banks``/``subarrays``
    override it, so a trace can be checked against a SMALLER device than
    it was captured on (out-of-device COPY destinations become PIM301).
    The PIM4xx semantic tier is ON by default for traces (files are the
    audit path; pass ``semantic=False`` to stay structural-only)."""
    progs = ir.from_trace_device(text)
    hdr_banks, hdr_subs = len(progs), len(progs[0])
    shapes = {(p.num_rows, p.words) for bank in progs for p in bank}
    rows, words = shapes.pop()
    cfg = DeviceConfig(channels=1, ranks=1, banks_per_rank=hdr_banks,
                       subarrays=hdr_subs, num_rows=rows, words=words)
    report = lint_schedule(cfg, [list(bank) for bank in progs],
                           async_host=async_host, semantic=semantic)
    diags = list(report.diagnostics)
    want_b = hdr_banks if banks is None else int(banks)
    want_s = hdr_subs if subarrays is None else int(subarrays)
    if (want_b, want_s) != (hdr_banks, hdr_subs):
        for bk, bank in enumerate(progs):
            for sb, prog in enumerate(bank):
                cols = prog.columns
                m = ((cols.code == _COPY)
                     & ~(((cols.delta == ir.COPY_SELF)
                          & (cols.c == ir.COPY_SELF))
                         | ((cols.delta == 0) & (cols.c == 0)))
                     & ((cols.delta >= want_b) | (cols.c >= want_s)))
                for i in np.flatnonzero(m):
                    diags.append(Diagnostic(
                        code="PIM301", severity=ERROR, slot=(bk, sb),
                        op_index=int(i),
                        trace_line=(prog.trace_lines[i]
                                    if prog.trace_lines else None),
                        message=f"COPY destination ({int(cols.delta[i])}, "
                                f"{int(cols.c[i])}) outside the linted "
                                f"device ({want_b} banks x {want_s} "
                                "subarrays)"))
    return LintReport(tuple(diags))


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.core.pim.lint <trace>... [--json out.json]
# ---------------------------------------------------------------------------

def _trace_directives(text: str) -> dict:
    """Parse ``# pimlint: key=value ...`` and ``# pimverify: key=value``
    comment directives (fixture self-description: expected code, device
    overrides, reference trace for equivalence proof)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("#"):
            continue
        for marker in ("pimlint:", "pimverify:"):
            if marker in line:
                for tok in line.split(marker, 1)[1].split():
                    k, _, v = tok.partition("=")
                    out[k] = v
    return out


def _pimverify_diags(path: str, text: str, ref: str) -> list[Diagnostic]:
    """PIM405: prove this trace equivalent to the reference trace named
    by its ``# pimverify: equiv=<file>`` directive (resolved relative to
    the trace's own directory). DIFFERENT is an ERROR carrying the
    distinguishing component + witness lane; UNKNOWN degrades to a
    WARNING (the proof did not go through — not a proved bug)."""
    from . import sem
    ref_path = os.path.join(os.path.dirname(os.path.abspath(path)), ref)
    try:
        with open(ref_path) as f:
            ref_text = f.read()
        progs = ir.from_trace_device(text)
        ref_progs = ir.from_trace_device(ref_text)
        flat = [p for bank in progs for p in bank]
        ref_flat = [p for bank in ref_progs for p in bank]
        if len(flat) != 1 or len(ref_flat) != 1:
            raise ValueError("pimverify: equiv= requires single-slot "
                             "traces on both sides")
        report = sem.prove_equivalent(flat[0], ref_flat[0])
    except (OSError, ValueError) as e:
        return [Diagnostic(code="PIM405", severity=ERROR,
                           message=f"pimverify equiv={ref}: {e}")]
    if report.verdict == sem.EQUIVALENT:
        return []
    if report.verdict == sem.DIFFERENT:
        w = report.witness
        where = (f" (component {report.component}, lane {w.lane})"
                 if w is not None else "")
        return [Diagnostic(code="PIM405", severity=ERROR,
                           message=f"trace is NOT equivalent to {ref}"
                                   f"{where}")]
    return [Diagnostic(code="PIM405", severity=WARNING,
                       message=f"equivalence to {ref} could not be "
                               f"proved (unknown: "
                               f"{', '.join(report.unknown) or '?'})")]


def lint_trace_file(path: str, *, banks: int | None = None,
                    subarrays: int | None = None,
                    async_host: bool = False,
                    semantic: bool = True) -> LintReport:
    """Lint a pim-trace FILE: ``lint_trace`` plus the file-scoped extras
    — in-file ``# pimlint: banks=/subarrays=`` device overrides (explicit
    arguments win), parse failures wrapped as a PARSE diagnostic, and the
    ``# pimverify: equiv=<file>`` equivalence proof (PIM405), whose
    relative reference resolves against the trace's directory."""
    with open(path) as f:
        text = f.read()
    directives = _trace_directives(text)
    if banks is None and "banks" in directives:
        banks = int(directives["banks"])
    if subarrays is None and "subarrays" in directives:
        subarrays = int(directives["subarrays"])
    try:
        report = lint_trace(text, banks=banks, subarrays=subarrays,
                            async_host=async_host, semantic=semantic)
    except ValueError as e:
        return LintReport((Diagnostic(code="PARSE", severity=ERROR,
                                      message=str(e)),))
    diags = report.diagnostics
    if semantic and "equiv" in directives:
        diags = tuple(sorted(
            diags + tuple(_pimverify_diags(path, text, directives["equiv"])),
            key=lambda d: (d.severity != ERROR,
                           d.op_index if d.op_index is not None
                           else 1 << 60, d.code)))
    return LintReport(diags)


def _lint_one_file(path: str, args) -> tuple[str, LintReport, str | None]:
    """(name, report, expected-code-or-None); parse failures become a
    single PARSE error diagnostic so the CLI never tracebacks on input."""
    with open(path) as f:
        text = f.read()
    expect = args.expect or _trace_directives(text).get("expect")
    report = lint_trace_file(path, banks=args.banks,
                             subarrays=args.subarrays,
                             async_host=args.async_host,
                             semantic=not args.no_semantic)
    return path, report, expect


def main(argv=None) -> int:
    """Exit codes: 0 clean (or every ``--expect`` matched), 1 diagnostics
    (errors; warnings too under ``--strict``), 2 usage errors."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.pim.lint",
        description="Static verifier for pim-trace files, PIM programs "
                    "and schedules (see DESIGN.md section 12 for the "
                    "diagnostic catalog).")
    ap.add_argument("traces", nargs="*", help="pim-trace files to lint")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full JSON report to PATH")
    ap.add_argument("--banks", type=int, default=None,
                    help="lint against this many banks (default: header)")
    ap.add_argument("--subarrays", type=int, default=None,
                    help="lint against this many subarrays per bank")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail (exit 1)")
    ap.add_argument("--expect", metavar="CODE",
                    help="golden-fixture mode: succeed iff CODE is among "
                         "the diagnostics (overrides in-file directives)")
    ap.add_argument("--async-host", action="store_true",
                    help="also run the async-host hiding analysis")
    ap.add_argument("--no-semantic", action="store_true",
                    help="skip the PIM4xx semantic tier and the "
                         "pimverify/workload equivalence proofs")
    ap.add_argument("--workloads", action="store_true",
                    help="lint the repo's canonical in-memory workloads "
                         "(shift pipeline, XOR reduce, sharded layouts) "
                         "instead of trace files")
    ap.add_argument("--device", default=None,
                    help="where --workloads records its PimVM programs "
                         "(default: the CUDA card; 'cpu' to run without "
                         "one)")
    args = ap.parse_args(argv)
    if not args.traces and not args.workloads:
        ap.print_usage(sys.stderr)
        print("error: no traces given (or use --workloads)",
              file=sys.stderr)
        return 2

    results: list[tuple[str, LintReport, str | None]] = []
    if args.workloads:
        device = resolve_device(args.device)
        for name, report in _workload_reports():
            results.append((name, report, None))
        if not args.no_semantic:
            for name, report in _semantic_reports(device):
                results.append((name, report, None))
    for path in args.traces:
        try:
            results.append(_lint_one_file(path, args))
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    failed = False
    for name, report, expect in results:
        if expect:
            hit = expect in report.codes()
            status = ("ok" if hit else
                      f"MISSING {expect} (got {sorted(set(report.codes()))})")
            print(f"{name}: expect {expect}: {status}")
            failed |= not hit
        else:
            bad = (not report.ok) or (args.strict and report.warnings)
            print(f"{name}: {report.render()}")
            failed |= bool(bad)
    if args.json:
        payload = {name: report.to_json() for name, report, _ in results}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return 1 if failed else 0


def _workload_reports():
    """Lint the benchmark-backing workload generators (the 'benchmark-
    generated traces' leg of `make pimlint`): every one must be
    error-free."""
    from .program import shift_workload_program
    from .schedule import (gather_rows, shard_rows, xor_reduce_program)
    from .device import paper_device

    out = []
    prog = shift_workload_program(256)
    out.append(("workload:shift_workload(256)", lint_program(prog)))

    cfg = paper_device(4, num_rows=32, words=8)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2**32, (12, 8), dtype=np.uint32)
    layout = shard_rows(data, cfg.n_banks, cfg.num_rows, read_back=True)
    out.append(("workload:shard_rows[4 banks]",
                lint_schedule(cfg, layout)))

    xr = xor_reduce_program(32, 8, rows=[0, 1, 2], dst=3)
    out.append(("workload:xor_reduce", lint_program(xr)))

    cfg2 = paper_device(2, num_rows=32, words=8, subarrays=2)
    moves = [((0, 0, 0), (1, 0, 4)), ((0, 1, 0), (1, 1, 4))]
    fused = gather_rows(cfg2, moves, shard_rows(
        data[:8], cfg2.n_banks, cfg2.num_rows, subarrays=2))
    out.append(("workload:gather_rows+shard[2x2]",
                lint_schedule(cfg2, fused)))
    return out


def _recorded_xtime(device=None) -> ir.PimProgram:
    """Record (never execute) one GF(2^8) xtime over a symbolic input
    register — the deepest real kernel in the repo at 16 symbolic inputs,
    right at the analyzer's default budget. The VM lives on ``device``
    (the card unless ``"cpu"``)."""
    from ..bitplane import gf
    from ..bitplane.vm import PimVM
    vm = PimVM(8, num_rows=64, words=1, device=device)
    a = vm.alloc()
    gf.xtime(vm, a)
    return vm.take_recorded()


def _recorded_rs_encode(device=None) -> ir.PimProgram:
    """Record an RS(n, n-2) encode of a concrete 3-symbol message (4 byte
    lanes at words=1); loads are constants in the semantic domain, so the
    whole LFSR folds and the fusion proof is exercised end to end. The VM
    lives on ``device`` (the card unless ``"cpu"``)."""
    from ..bitplane import rs
    from ..bitplane.vm import PimVM
    vm = PimVM(8, num_rows=128, words=1, device=device)
    msg = [vm.load([i + 1, 2 * i + 3, 7 * i + 5, i * i + 1])
           for i in range(3)]
    rs.rs_encode(vm, msg, 2)
    return vm.take_recorded()


def _semantic_reports(device=None):
    """The proof leg of ``--workloads``: every canonical kernel must pass
    its own fused-vs-unfused equivalence gate, and the flagship streams
    must summarize to the closed forms the paper promises. Failures show
    up as ``SEM`` error diagnostics so they fold into the same report/
    exit-code machinery as the lint checks."""
    from . import sem
    from .program import ambit_xor_program, shift_workload_program
    from .schedule import xor_reduce_program

    def check(name, fn):
        try:
            msg = fn()
        except Exception as e:          # a crash IS a failed proof here
            msg = f"{type(e).__name__}: {e}"
        diags = () if msg is None else (
            Diagnostic(code="SEM", severity=ERROR, message=str(msg)),)
        return (f"sem:{name}", LintReport(diags))

    def xor_proved():
        prog = ambit_xor_program()
        got = sem.summarize(prog).get(2)
        if got != "r0 ^ r1":
            return f"ambit_xor row 2 summarizes to {got!r}, not 'r0 ^ r1'"
        rep = sem.fusion_report(prog)
        if rep.verdict != sem.EQUIVALENT:
            return f"ambit_xor fusion verdict {rep.verdict}"
        return None

    def fusion_of(prog):
        def fn():
            rep = sem.fusion_report(prog)
            if rep.verdict != sem.EQUIVALENT:
                return f"fusion verdict {rep.verdict}" + (
                    f" (unknown: {', '.join(rep.unknown)})"
                    if rep.unknown else "")
            return None
        return fn

    return [
        check("ambit_xor", xor_proved),
        check("shift_workload(256)",
              fusion_of(shift_workload_program(256, num_rows=64,
                                               words=32))),
        check("xor_reduce",
              fusion_of(xor_reduce_program(32, 8, rows=[0, 1, 2], dst=3))),
        check("gf.xtime", fusion_of(_recorded_xtime(device))),
        check("rs.encode", fusion_of(_recorded_rs_encode(device))),
    ]


if __name__ == "__main__":
    sys.exit(main())
