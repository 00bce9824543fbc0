"""pimsem: symbolic semantic analyzer — prove what PIM programs compute.

Port of ``repro.core.pim.sem``: the same numpy abstract interpreter over
the port's copy of the columnar IR, with caches of its own. Only
:func:`check_witness` runs programs, through the port's eager ISA on
``device``.

A vectorized abstract interpreter over the cached columnar IR
(:class:`~.ir.ProgramColumns`): no execution, no tracing, no jax. The
abstract domain is *boolean functions of named symbolic input rows*,
represented as packed-uint64 truth tables over at most ``max_inputs``
variables — numpy bit-parallel across both the 2^k truth-table axis and
the subarray's bit lanes — with a lattice top (``TOP``) fallback when a
value's support outgrows the budget.

Variables are ``(row, disp)`` pairs: the variable ``(r, d)`` evaluated at
lane ``L`` denotes input bit ``L - d`` of row ``r``'s *initial* contents.
A 1-bit migration-cell SHIFT is then exact and cheap: the truth tables
roll one lane (the boundary lane becomes constant 0 — the paper's "edge
bit falls off, fill 0" semantics), and every support variable's
displacement moves by the shift delta. Because the support is kept
lexicographically sorted and a shift displaces every variable uniformly,
no truth-table column permutation is ever needed.

Soundness invariant (by induction over the transfer functions): at every
lane ``L``, a value's truth table has zero dependence on any support
variable ``(r, d)`` whose referenced input bit ``L - d`` lies outside
``[0, lanes)``. Fresh inputs have ``d = 0``; a shift zeroes exactly the
lanes where newly out-of-range references appear; bitwise ops cannot
introduce dependence their operands lack. Consequently truth-table
equality over the union support is *exact* equality of the concrete
functions, and any truth-table difference yields a concrete witness
assignment touching only in-range input bits.

Built on top:

``summarize(program)``
    Per-row closed-form boolean expression of every written row.

``prove_equivalent(a, b, *, inputs, outputs)``
    Sound verdict contract: ``EQUIVALENT`` (exact), ``DIFFERENT`` plus a
    concrete :class:`Witness` assignment that provably distinguishes the
    two programs under the eager ISA, or ``UNKNOWN`` (a compared value
    hit ``TOP`` or the truth-table budget). Never a false EQUIVALENT.

``semantic_findings(program)``
    The PIM4xx diagnostic tier consumed by ``lint.py``: PIM401 (op
    computes a constant), PIM402 (MAJ with symbolically equal operands),
    PIM403 (cancelling NOT/NOT or net-zero SHIFT chains), PIM404
    (semantically no-op write).

``fusion_report(program, segments)`` / ``verify_fusion``
    Abstractly interprets the *fused* segment list (``compile.fuse``)
    against the unfused op stream and proves them equivalent — the
    ``verify_semantics=True`` gate on ``compile.fuse``/``compile_program``.

The initial abstract state matches ``state.make_subarray``: migration
rows and the DCC row start as constant 0; ``assume_control=True``
(default) additionally seeds C0/C1 with their ``reserve_control_rows``
constants. Witnesses replay through ``isa.run_on_bits`` under the same
convention, so every DIFFERENT verdict is executable by construction.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import ir, isa
from .timing import DDR3Timing, DEFAULT_TIMING

__all__ = [
    "Analysis", "EQUIVALENT", "DIFFERENT", "UNKNOWN", "DEFAULT_MAX_INPUTS",
    "EquivReport", "EquivalenceError", "SEM_STATS", "SymVal", "TOP",
    "Witness", "analyze", "check_witness", "fusion_report", "is_const",
    "lane_const", "prove_equivalent", "semantic_findings", "summarize",
    "verify_fusion",
]

EQUIVALENT = "EQUIVALENT"
DIFFERENT = "DIFFERENT"
UNKNOWN = "UNKNOWN"

# Default symbolic-input budget: a value may depend on at most this many
# (row, disp) variables before collapsing to TOP.
DEFAULT_MAX_INPUTS = 16

# Resource guard on expanded truth tables: lanes * 2^k single-bit elements.
# Strictly-greater comparison so the differential harness's largest case
# (128 lanes x 2^16 assignments == 1 << 23) still analyzes exactly.
_MAX_TT_ELEMS = 1 << 23

_MAX_FINDINGS = 64

SEM_STATS = {"analyses": 0, "analysis_hits": 0, "proofs": 0,
             "proof_hits": 0, "top_values": 0}

_U1 = np.uint64(1)
_U6 = np.uint64(6)
_U63 = np.uint64(63)
_ONES = np.uint64(0xFFFF_FFFF_FFFF_FFFF)

# Truth-table bit pattern of variable p (p < 6) within one uint64 word:
# assignment j has variable p set iff bit p of j is set, so the pattern
# alternates in blocks of 2^p. Tables with k < 6 variables replicate
# their 2^k-bit table to fill the word (stable under all bitwise ops),
# which makes these patterns exact for every k.
_VAR_WORDS = (
    np.uint64(0xAAAA_AAAA_AAAA_AAAA), np.uint64(0xCCCC_CCCC_CCCC_CCCC),
    np.uint64(0xF0F0_F0F0_F0F0_F0F0), np.uint64(0xFF00_FF00_FF00_FF00),
    np.uint64(0xFFFF_0000_FFFF_0000), np.uint64(0xFFFF_FFFF_0000_0000))


class _Top:
    """Lattice top: value exceeded the symbolic budget. Singleton."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "TOP"


TOP = _Top()


class SymVal:
    """One abstract row value: ``sup`` is the lex-sorted tuple of
    ``(row, disp)`` variables, ``tt`` the packed truth tables — uint64
    array of shape ``(lanes, max(1, 2^k >> 6))`` with ``k = len(sup)``;
    for ``k < 6`` the 2^k-bit table is replicated across the word."""

    __slots__ = ("sup", "tt", "neg_of", "cancels", "shift_base",
                 "shift_net", "_shrunk")

    def __init__(self, sup: tuple, tt: np.ndarray):
        self.sup = sup
        self.tt = tt
        # Findings-pass provenance (PIM403): what this value is a NOT of,
        # whether it closes a NOT/NOT pair, and the shift-chain origin.
        self.neg_of = None
        self.cancels = False
        self.shift_base = None
        self.shift_net = 0
        self._shrunk = None

    def __repr__(self) -> str:
        return f"SymVal(sup={self.sup}, lanes={self.tt.shape[0]})"


def _n_words(k: int) -> int:
    return 1 if k < 6 else 1 << (k - 6)


def _const_val(lanes: int, on: bool) -> SymVal:
    tt = np.full((lanes, 1), _ONES if on else np.uint64(0), np.uint64)
    return SymVal((), tt)


def _var(row: int, lanes: int) -> SymVal:
    tt = np.full((lanes, 1), _VAR_WORDS[0], np.uint64)
    return SymVal(((int(row), 0),), tt)


def _row_to_lane_bits(row: np.ndarray) -> np.ndarray:
    """(words,) uint32 -> (lanes,) bool: little-endian lane bits."""
    w = np.asarray(row, np.uint32)
    bits = (w[:, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return bits.reshape(-1).astype(bool)


def _const_lanes(mask: np.ndarray) -> SymVal:
    """Per-lane constant from a (lanes,) bool mask."""
    tt = np.where(mask, _ONES, np.uint64(0)).astype(np.uint64)
    return SymVal((), tt.reshape(-1, 1))


@functools.lru_cache(maxsize=1024)
def _gather_arrays(k_to: int, moves: tuple):
    """Gather indices remapping a truth table between variable layouts.

    ``moves`` is a tuple of ``(src_pos, dst_pos)``: source variable at
    bit position ``src_pos`` appears at position ``dst_pos`` of the
    target support. For every target assignment ``j`` the source
    assignment reads the moved bits (dropped source variables stay 0 —
    only valid when the table does not depend on them, which both
    callers guarantee). Returns ``(word_idx, bit_shift)`` arrays of
    length ``2^k_to``."""
    j = np.arange(1 << k_to, dtype=np.uint64)
    src = np.zeros(1 << k_to, np.uint64)
    for sp, dp in moves:
        src |= ((j >> np.uint64(dp)) & _U1) << np.uint64(sp)
    return (src >> _U6).astype(np.intp), (src & _U63)


def _pack_bits(bits: np.ndarray, k: int) -> np.ndarray:
    """(lanes, 2^k) 0/1 uint64 -> packed (lanes, n_words(k)) table."""
    lanes = bits.shape[0]
    if k >= 6:
        b = bits.reshape(lanes, -1, 64)
        return np.bitwise_or.reduce(
            b << np.arange(64, dtype=np.uint64), axis=-1)
    w = np.bitwise_or.reduce(
        bits << np.arange(1 << k, dtype=np.uint64), axis=-1)
    for p in range(k, 6):          # replicate the 2^k-bit table wordwide
        w = w | (w << np.uint64(1 << p))
    return w.reshape(lanes, 1)


def _remap(tt: np.ndarray, k_to: int, moves: tuple) -> np.ndarray:
    """Re-express ``tt`` over a ``k_to``-variable layout via ``moves``."""
    widx, bshift = _gather_arrays(k_to, moves)
    bits = (tt[:, widx] >> bshift) & _U1
    return _pack_bits(bits, k_to)


def _to_sup(val: SymVal, sup: tuple) -> np.ndarray:
    """``val``'s truth table expanded to the (superset) support ``sup``."""
    if val.sup == sup:
        return val.tt
    pos = {v: i for i, v in enumerate(sup)}
    moves = tuple((i, pos[v]) for i, v in enumerate(val.sup))
    return _remap(val.tt, len(sup), moves)


def _depends(tt: np.ndarray, p: int) -> bool:
    """Does the table depend on the variable at bit position ``p``?"""
    if p < 6:
        d = (tt >> np.uint64(1 << p)) ^ tt
        return bool(np.any(d & ~_VAR_WORDS[p]))
    step = 1 << (p - 6)
    lanes, w = tt.shape
    blocks = tt.reshape(lanes, w // (2 * step), 2, step)
    return bool(np.any(blocks[:, :, 0, :] ^ blocks[:, :, 1, :]))


def _shrink(v):
    """Canonical form: drop support variables the table never depends on
    (cached on the value). TOP shrinks to TOP."""
    if v is TOP:
        return TOP
    if v._shrunk is not None:
        return v._shrunk
    k = len(v.sup)
    dep = [p for p in range(k) if _depends(v.tt, p)]
    if len(dep) == k:
        out = v
    else:
        sup = tuple(v.sup[p] for p in dep)
        out = SymVal(sup, _remap(v.tt, len(dep),
                                 tuple((old, new)
                                       for new, old in enumerate(dep))))
        out._shrunk = out
    v._shrunk = out
    return out


def is_const(v) -> bool:
    """True iff the value is a per-lane constant (no symbolic support)."""
    if v is TOP:
        return False
    return not _shrink(v).sup


def lane_const(v, lane: int):
    """The provable constant bit of ``v`` at ``lane`` (0 or 1), else
    ``None`` when the lane depends on symbolic inputs (or ``v`` is TOP)."""
    if v is TOP:
        return None
    row = v.tt[lane]
    if not row.any():
        return 0
    if bool(np.all(row == _ONES)):
        return 1
    return None


def _cheap_eq(x, y) -> bool:
    """Sufficient (sound, incomplete) equality: same object, or same
    support with identical tables."""
    if x is TOP or y is TOP:
        return False
    if x is y:
        return True
    return x.sup == y.sup and np.array_equal(x.tt, y.tt)


def _union_sup(*vals) -> tuple:
    s: set = set()
    for v in vals:
        s.update(v.sup)
    return tuple(sorted(s))


def _diff(va, vb, lanes: int, max_inputs: int):
    """Exact comparison of two values.

    Returns ``("eq", ...)``, ``("ne", lane, assignment, sup)`` with the
    first differing lane and truth-table assignment index over the union
    support, or ``("unknown", ...)`` when either value is TOP or the
    union table exceeds the budget."""
    if va is TOP or vb is TOP:
        return ("unknown", None, None, None)
    if va is vb:
        return ("eq", None, None, None)
    sup = _union_sup(va, vb)
    k = len(sup)
    if k > max_inputs or lanes * (1 << k) > _MAX_TT_ELEMS:
        return ("unknown", None, None, None)
    d = _to_sup(va, sup) ^ _to_sup(vb, sup)
    nz = np.nonzero(d)
    if nz[0].size == 0:
        return ("eq", None, None, None)
    lane, w = int(nz[0][0]), int(nz[1][0])
    word = int(d[lane, w])
    j = w * 64 + ((word & -word).bit_length() - 1)
    if k < 6:
        j %= 1 << k                # table replicated with period 2^k
    return ("ne", lane, j, sup)


def _eq_opt(x, y, lanes: int, max_inputs: int):
    """True / False / None(unknown) equality used by the findings pass."""
    if _cheap_eq(x, y):
        return True
    verdict = _diff(x, y, lanes, max_inputs)[0]
    return {"eq": True, "ne": False}.get(verdict)


# ---------------------------------------------------------------------------
# The abstract machine
# ---------------------------------------------------------------------------

class Analysis:
    """Abstract state of one interpreted stream: ``env`` maps row ->
    value (SymVal or TOP), ``reads`` are the host-read values in slot
    order, ``dcc``/``mig_top``/``mig_bot`` the side-state rows, and
    ``written`` the rows the stream wrote."""

    def __init__(self, num_rows: int, words: int, *,
                 max_inputs: int = DEFAULT_MAX_INPUTS,
                 assume_control: bool = True, inputs=None):
        self.num_rows = int(num_rows)
        self.words = int(words)
        self.lanes = self.words * 32
        self.max_inputs = int(max_inputs)
        self.assume_control = bool(assume_control)
        self.inputs = (None if inputs is None else
                       frozenset(int(r) % self.num_rows for r in inputs))
        self.const0 = _const_val(self.lanes, False)
        self.const1 = _const_val(self.lanes, True)
        self._control = frozenset(
            int(r) % self.num_rows for r in (isa.C0, isa.C1))
        self._even = (np.arange(self.lanes) & 1) == 0
        self.env: dict = {}
        if self.assume_control:
            self.env[int(isa.C0) % self.num_rows] = self.const0
            self.env[int(isa.C1) % self.num_rows] = self.const1
        # make_subarray zeroes the migration rows and the DCC row.
        self.dcc = self.const0
        self.mig_top = self.const0
        self.mig_bot = self.const0
        self.reads: list = []
        self.written: set = set()
        self.n_top = 0

    # -- reads / writes -------------------------------------------------------
    def value(self, r: int):
        """Current abstract value of row ``r`` (lazily a fresh symbolic
        input — or constant 0 outside the declared ``inputs`` set)."""
        v = self.env.get(r)
        if v is None:
            if self.inputs is not None and r not in self.inputs:
                v = self.const0
            else:
                v = _var(r, self.lanes)
            self.env[r] = v
        return v

    def _top(self):
        self.n_top += 1
        SEM_STATS["top_values"] += 1
        return TOP

    def _write(self, b: int, v, op_index, emit) -> None:
        if (emit is not None
                and not (self.assume_control and b in self._control)):
            old = self.value(b)
            if _eq_opt(old, v, self.lanes, self.max_inputs) is True:
                emit("PIM404", op_index,
                     f"write to row {b} is a semantic no-op: the row "
                     "already holds exactly this value")
        self.env[b] = v
        self.written.add(b)

    # -- transfer functions ---------------------------------------------------
    def maj(self, va, vb, vc):
        # maj(x, x, z) == x for ANY z (even TOP) — but only when the two
        # equal operands are the same known value, never the TOP object.
        if va is not TOP and (va is vb or _cheap_eq(va, vb)
                              or va is vc or _cheap_eq(va, vc)):
            return va
        if vb is not TOP and (vb is vc or _cheap_eq(vb, vc)):
            return vb
        if va is TOP or vb is TOP or vc is TOP:
            return self._top()
        sup = _union_sup(va, vb, vc)
        k = len(sup)
        if k > self.max_inputs or self.lanes * (1 << k) > _MAX_TT_ELEMS:
            return self._top()
        ta, tb, tc = (_to_sup(v, sup) for v in (va, vb, vc))
        return SymVal(sup, (ta & tb) | (ta & tc) | (tb & tc))

    def not_(self, v):
        if v is TOP:
            return self._top()
        out = SymVal(v.sup, ~v.tt)
        out.neg_of = v
        out.cancels = v.neg_of is not None
        return out

    def _displace(self, v, m: int):
        """Value shifted ``m`` lanes with boundary zero fill; support
        displacements move uniformly by ``m`` (order-preserving)."""
        if v is TOP:
            return TOP
        if m == 0:
            return v
        if abs(m) >= self.lanes:
            # Fresh constant, not the shared const0: shift_chain annotates
            # provenance fields on its result.
            return _const_val(self.lanes, False)
        tt = np.roll(v.tt, m, axis=0)
        if m > 0:
            tt[:m] = 0
        else:
            tt[m:] = 0
        return SymVal(tuple((r, d + m) for (r, d) in v.sup), tt)

    def _mask_parity(self, v, even: bool):
        if v is TOP:
            return TOP
        tt = v.tt.copy()
        tt[~self._even if even else self._even] = 0
        return SymVal(v.sup, tt)

    def shift_chain(self, src: int, dst: int, delta: int, k: int, *,
                    op_index=None, emit=None) -> None:
        """``k`` chained 1-bit shifts src->dst(->dst...), one direction —
        exactly the eager loop and ``compile.SegShiftRun``: the result is
        the source displaced ``delta*k`` lanes, the migration rows hold
        the parity masks of the ``delta*(k-1)``-displaced value (the last
        hop's captures)."""
        v = self.value(src)
        res = self._displace(v, delta * k)
        pre = self._displace(v, delta * (k - 1))
        self.mig_top = self._mask_parity(pre, even=delta > 0)
        self.mig_bot = self._mask_parity(pre, even=delta < 0)
        if res is not TOP and v is not TOP:
            base, net = ((v.shift_base, v.shift_net)
                         if v.shift_base is not None else (v, 0))
            res.shift_base, res.shift_net = base, net + delta * k
            if emit is not None:
                if is_const(res) and not is_const(v):
                    emit("PIM401", op_index,
                         f"SHIFT chain (|k|={k}) shifts row {src} "
                         "entirely past the subarray boundary: the "
                         "result is constant 0")
                elif (res.shift_net == 0 and base is not TOP
                      and _eq_opt(res, base, self.lanes,
                                  self.max_inputs) is True):
                    emit("PIM403", op_index,
                         "SHIFT chain returns to net displacement 0 and "
                         "provably cancels (every displaced-off edge "
                         "lane was already 0)")
        self.env[dst] = res
        self.written.add(dst)

    def tra(self, a: int, b: int, c: int, *, op_index=None,
            emit=None) -> None:
        va, vb, vc = self.value(a), self.value(b), self.value(c)
        if emit is not None:
            for r1, r2, x, y in ((a, b, va, vb), (a, c, va, vc),
                                 (b, c, vb, vc)):
                if x is not TOP and _eq_opt(
                        x, y, self.lanes, self.max_inputs) is True:
                    emit("PIM402", op_index,
                         f"TRA operand rows {r1} and {r2} hold "
                         "symbolically equal values: MAJ degenerates to "
                         "the duplicated operand")
                    break
        m = self.maj(va, vb, vc)
        if (emit is not None and m is not TOP and is_const(m)
                and any(v is not TOP and not is_const(v)
                        for v in (va, vb, vc))):
            emit("PIM401", op_index,
                 "TRA computes a per-lane constant from non-constant "
                 "operands: the majority cancels its symbolic inputs")
        for r in (a, b, c):
            self.env[r] = m
            self.written.add(r)

    # -- op dispatch ----------------------------------------------------------
    def apply(self, op: ir.PimOp, payloads, *, op_index=None, emit=None,
              allow_remote: bool = False) -> None:
        kind = op.op
        if kind == ir.OP_ISSUE:
            return
        if kind in (ir.OP_ROWCLONE, ir.OP_DRA):
            self._write(op.b, self.value(op.a), op_index, emit)
        elif kind == ir.OP_COPY:
            if not ir.copy_is_local(op):
                if allow_remote:
                    self.value(op.a)     # local effect is the read only
                    return
                raise ValueError(
                    f"cross-subarray COPY to ({op.delta}, {op.c}) has no "
                    "single-subarray semantics; analyze per-slot streams "
                    "or route through the device scheduler")
            self._write(op.b, self.value(op.a), op_index, emit)
        elif kind == ir.OP_TRA:
            self.tra(op.a, op.b, op.c, op_index=op_index, emit=emit)
        elif kind == ir.OP_NOT2DCC:
            self.dcc = self.not_(self.value(op.a))
        elif kind == ir.OP_DCC2:
            v = self.dcc
            if emit is not None and v is not TOP and v.cancels:
                emit("PIM403", op_index,
                     "NOT of a NOT: this DCC2 materializes a value "
                     "identical to the one two NOTs ago")
            self._write(op.b, v, op_index, emit)
        elif kind == ir.OP_SHIFT:
            self.shift_chain(op.a, op.b, int(op.delta), 1,
                             op_index=op_index, emit=emit)
        elif kind == ir.OP_WRITE:
            v = _const_lanes(_row_to_lane_bits(payloads[op.payload]))
            self._write(op.b, v, op_index, emit)
        elif kind == ir.OP_READ:
            self.reads.append(self.value(op.a))
        elif kind == ir.OP_FILL:
            word = np.full((self.words,), op.payload & 0xFFFF_FFFF,
                           np.uint32)
            self._write(op.b, _const_lanes(_row_to_lane_bits(word)),
                        op_index, emit)
        else:
            raise ValueError(kind)


_SHIFT_C = ir.OP_CODE[ir.OP_SHIFT]


def _shift_run_ends(cols: ir.ProgramColumns) -> np.ndarray:
    """Columnar shift-chain detection (the ``compile._shift_runs``
    contract, duplicated so sem stays a numpy leaf): ``run_end[s]`` is
    one past the last op of the chain starting at ``s`` (-1 elsewhere)."""
    n = len(cols.table)
    code, a, b, delta = cols.code, cols.a, cols.b, cols.delta
    is_shift = code == _SHIFT_C
    cont = np.zeros(n, bool)
    if n > 1:
        cont[1:] = (is_shift[1:] & is_shift[:-1] & (a[1:] == b[1:])
                    & (b[1:] == b[:-1]) & (delta[1:] == delta[:-1]))
    run_end = np.full(n, -1, np.int64)
    starts = np.flatnonzero(is_shift & ~cont)
    if starts.size:
        breaks = np.flatnonzero(~cont)
        run_end[starts] = np.append(breaks, n)[
            np.searchsorted(breaks, starts, side="right")]
    return run_end


def _interpret(m: Analysis, program: ir.PimProgram, *, emit=None,
               allow_remote: bool = False) -> Analysis:
    """Drive the machine over the op stream. Maximal same-direction
    shift chains collapse to ONE abstract shift (a 100k-hop stream is a
    single ``np.roll``), so analysis stays sub-second at lint scale."""
    ops = program.ops
    n = len(ops)
    if n == 0:
        return m
    cols = program.columns
    run_end = _shift_run_ends(cols) if (cols.code == _SHIFT_C).any() \
        else None
    i = 0
    while i < n:
        op = ops[i]
        if op.op == ir.OP_SHIFT:
            j = int(run_end[i]) if run_end is not None else -1
            if j < 0:
                j = i + 1
            m.shift_chain(op.a, op.b, int(op.delta), j - i,
                          op_index=j - 1, emit=emit)
            i = j
            continue
        m.apply(op, program.payloads, op_index=i, emit=emit,
                allow_remote=allow_remote)
        i += 1
    return m


# ---------------------------------------------------------------------------
# analyze / summarize / findings (payload-CONTENT-keyed caches)
# ---------------------------------------------------------------------------

_SEM_CACHE: dict = {}
_SEM_CACHE_MAX = 256


def _cache_key(tag: str, program: ir.PimProgram, *extra):
    # Payload CONTENT digest, not shapes: HOSTW bits are constants in
    # this domain, so same-shape different-bits payloads must miss.
    return (tag, program.digest, program.payload_digest, program.num_rows,
            program.words) + extra


def _cache_put(key, val):
    if len(_SEM_CACHE) >= _SEM_CACHE_MAX:
        _SEM_CACHE.pop(next(iter(_SEM_CACHE)))
    _SEM_CACHE[key] = val
    return val


def _inputs_key(inputs, num_rows: int):
    return (None if inputs is None
            else frozenset(int(r) % num_rows for r in inputs))


def analyze(program: ir.PimProgram, *,
            max_inputs: int = DEFAULT_MAX_INPUTS,
            assume_control: bool = True, inputs=None) -> Analysis:
    """Abstractly interpret one stream; cached on the program digest plus
    the payload *content* digest (zero column-table rebuilds on warm
    hits). Cross-slot COPYs raise — analyze per-slot streams."""
    ik = _inputs_key(inputs, program.num_rows)
    key = _cache_key("analysis", program, max_inputs, assume_control, ik)
    hit = _SEM_CACHE.get(key)
    if hit is not None:
        SEM_STATS["analysis_hits"] += 1
        return hit
    SEM_STATS["analyses"] += 1
    m = Analysis(program.num_rows, program.words, max_inputs=max_inputs,
                 assume_control=assume_control, inputs=ik)
    _interpret(m, program)
    return _cache_put(key, m)


def semantic_findings(program: ir.PimProgram, *,
                      max_inputs: int = DEFAULT_MAX_INPUTS,
                      assume_control: bool = True) -> tuple:
    """The PIM4xx findings of one stream as ``(code, op_index, message)``
    tuples (per-code capped). Best-effort: a stream the machine cannot
    interpret (malformed payload references, out-of-range operands)
    yields no findings — the structural lint tier owns those errors.
    Cross-slot COPYs are skipped (their write lands in another slot)."""
    key = _cache_key("findings", program, max_inputs, assume_control)
    hit = _SEM_CACHE.get(key)
    if hit is not None:
        SEM_STATS["analysis_hits"] += 1
        return hit
    SEM_STATS["analyses"] += 1
    found: list = []
    counts: dict = {}

    def emit(code, op_index, message):
        n = counts.get(code, 0)
        counts[code] = n + 1
        if n < _MAX_FINDINGS:
            found.append((code, None if op_index is None else int(op_index),
                          message))

    m = Analysis(program.num_rows, program.words, max_inputs=max_inputs,
                 assume_control=assume_control)
    try:
        _interpret(m, program, emit=emit, allow_remote=True)
    except (IndexError, ValueError, TypeError):
        # What a malformed stream raises here: a payload index past the
        # payloads, a payload row of the wrong width, an unknown op.
        return _cache_put(key, ())
    return _cache_put(key, tuple(found))


# ---------------------------------------------------------------------------
# Closed-form rendering (summarize)
# ---------------------------------------------------------------------------

def _atom(pair: tuple, parens: bool = True) -> str:
    r, d = pair
    if d == 0:
        return f"r{r}"
    body = f"r{r} << {d}" if d > 0 else f"r{r} >> {-d}"
    return f"({body})" if parens else body


@functools.lru_cache(maxsize=256)
def _var_tt(p: int, k: int) -> np.ndarray:
    w = _n_words(k)
    if p < 6:
        return np.full(w, _VAR_WORDS[p], np.uint64)
    on = ((np.arange(w) >> (p - 6)) & 1) == 1
    return np.where(on, _ONES, np.uint64(0)).astype(np.uint64)


def _popcount_period(row: np.ndarray, k: int) -> tuple[int, int]:
    """(#ON assignments, index of the first ON) within one 2^k period."""
    if k < 6:
        word = int(row[0]) & ((1 << (1 << k)) - 1)
        return word.bit_count(), ((word & -word).bit_length() - 1
                                  if word else -1)
    total, first = 0, -1
    for wi, w in enumerate(row):
        w = int(w)
        total += w.bit_count()
        if first < 0 and w:
            first = wi * 64 + (w & -w).bit_length() - 1
    return total, first


def _render_row(row: np.ndarray, sup: tuple) -> str:
    k = len(sup)
    if k == 0:
        return "1" if row.any() else "0"
    names = [_atom(v) for v in sup]
    if k > 8:
        return f"fn({', '.join(names)})"
    if k == 1:
        if np.array_equal(row, _var_tt(0, 1)):
            return names[0]
        return f"~{names[0]}"
    parity = _var_tt(0, k).copy()
    for p in range(1, k):
        parity ^= _var_tt(p, k)
    if np.array_equal(row, parity):
        return " ^ ".join(names)
    if np.array_equal(row, ~parity):
        return f"~({' ^ '.join(names)})"
    if k == 3:
        v0, v1, v2 = (_var_tt(p, 3) for p in range(3))
        if np.array_equal(row, (v0 & v1) | (v0 & v2) | (v1 & v2)):
            return f"maj({', '.join(names)})"
    on, first_on = _popcount_period(row, k)
    period = 1 << k
    if on == 1:                                     # AND of literals
        lits = [names[i] if (first_on >> i) & 1 else f"~{names[i]}"
                for i in range(k)]
        return " & ".join(lits)
    if on == period - 1:                            # OR of literals
        _, first_off = _popcount_period(~row, k)
        lits = [f"~{names[i]}" if (first_off >> i) & 1 else names[i]
                for i in range(k)]
        return " | ".join(lits)
    if k <= 4 and on <= 8:                          # small DNF
        terms = []
        for j in range(period):
            if k < 6:
                bit = (int(row[0]) >> j) & 1
            else:
                bit = (int(row[j // 64]) >> (j % 64)) & 1
            if bit:
                lits = [names[i] if (j >> i) & 1 else f"~{names[i]}"
                        for i in range(k)]
                terms.append("(" + " & ".join(lits) + ")")
        return " | ".join(terms)
    return f"fn({', '.join(names)})"


def render_value(v) -> str:
    """Closed-form boolean expression of one abstract value. Lanes that
    disagree with the dominant pattern (boundary fill) are counted in a
    trailing annotation."""
    if v is TOP:
        return "TOP"
    sv = _shrink(v)
    patterns, counts = np.unique(sv.tt, axis=0, return_counts=True)
    main = patterns[int(np.argmax(counts))]
    expr = _render_row(main, sv.sup)
    n_edge = sv.tt.shape[0] - int(counts.max())
    if n_edge:
        expr += f" [{n_edge} boundary lane(s) differ]"
    return expr


def summarize(program: ir.PimProgram, *, rows=None,
              max_inputs: int = DEFAULT_MAX_INPUTS,
              assume_control: bool = True, inputs=None) -> dict:
    """Per-row closed-form expression of every written row (or of the
    explicit ``rows``) in terms of the named symbolic input rows."""
    m = analyze(program, max_inputs=max_inputs,
                assume_control=assume_control, inputs=inputs)
    targets = sorted(m.written) if rows is None else \
        [int(r) % m.num_rows for r in rows]
    return {r: render_value(m.value(r)) for r in targets}


# ---------------------------------------------------------------------------
# Equivalence proving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Witness:
    """A concrete distinguishing input assignment: set each row of
    ``rows`` into a fresh subarray (C1 seeded when ``assume_control``),
    run both programs eagerly, and the ``kind``/``index`` component
    differs. ``lane`` is the bit lane the static proof found."""

    kind: str                    # row | read | reads_len | dcc | mig_top |
    index: int | None            # mig_bot; row index / read slot
    lane: int | None
    rows: dict
    num_rows: int
    words: int
    assume_control: bool

    def as_bits(self) -> np.ndarray:
        bits = np.zeros((self.num_rows, self.words), np.uint32)
        for r, row in self.rows.items():
            bits[r] = row
        if self.assume_control:
            bits[int(isa.C1) % self.num_rows] = 0xFFFF_FFFF
            bits[int(isa.C0) % self.num_rows] = 0
        return bits


@dataclasses.dataclass(frozen=True)
class EquivReport:
    """Outcome of one equivalence proof. ``verdict`` is EQUIVALENT /
    DIFFERENT / UNKNOWN; DIFFERENT carries the ``witness`` and the
    ``component`` it distinguishes; UNKNOWN lists the components whose
    values hit TOP or the truth-table budget."""

    verdict: str
    witness: Witness | None = None
    component: str | None = None
    unknown: tuple = ()

    @property
    def ok(self) -> bool:
        return self.verdict == EQUIVALENT


class EquivalenceError(ValueError):
    """Raised by ``verify_fusion`` when fused != unfused (or unprovable)."""

    def __init__(self, report: EquivReport, what: str = "fusion"):
        self.report = report
        detail = (f"differs at {report.component}"
                  if report.verdict == DIFFERENT else
                  f"unprovable ({', '.join(report.unknown)} exceeded the "
                  "symbolic budget)")
        super().__init__(f"pimsem: {what} equivalence failed: "
                         f"{report.verdict} — {detail}")


def _witness_from(ma: Analysis, kind: str, index, lane, j, sup) -> Witness:
    rows: dict = {}
    if sup:
        for i, (r, dsp) in enumerate(sup):
            if (j >> i) & 1:
                pos = lane - dsp
                # Out-of-range references carry zero dependence at this
                # lane (the soundness invariant), so dropping the bit
                # preserves the difference.
                if 0 <= pos < ma.lanes:
                    row = rows.setdefault(r, np.zeros(ma.words, np.uint32))
                    row[pos // 32] |= np.uint32(1 << (pos % 32))
    return Witness(kind=kind, index=index, lane=lane, rows=rows,
                   num_rows=ma.num_rows, words=ma.words,
                   assume_control=ma.assume_control)


def _compare_analyses(ma: Analysis, mb: Analysis, outputs,
                      max_inputs: int) -> EquivReport:
    if len(ma.reads) != len(mb.reads):
        return EquivReport(
            verdict=DIFFERENT, component="number of host reads",
            witness=Witness(kind="reads_len", index=None, lane=None,
                            rows={}, num_rows=ma.num_rows, words=ma.words,
                            assume_control=ma.assume_control))
    comps: list = []
    if outputs is None:
        rows = sorted(ma.written | mb.written)
    else:
        rows = sorted({int(r) % ma.num_rows for r in outputs})
    comps += [("row", r, ma.value(r), mb.value(r)) for r in rows]
    comps += [("read", i, va, vb)
              for i, (va, vb) in enumerate(zip(ma.reads, mb.reads))]
    if outputs is None:
        comps += [("dcc", None, ma.dcc, mb.dcc),
                  ("mig_top", None, ma.mig_top, mb.mig_top),
                  ("mig_bot", None, ma.mig_bot, mb.mig_bot)]
    unknown: list = []
    for kind, index, va, vb in comps:
        name = kind if index is None else f"{kind} {index}"
        verdict, lane, j, sup = _diff(va, vb, ma.lanes, max_inputs)
        if verdict == "ne":
            return EquivReport(
                verdict=DIFFERENT, component=name,
                witness=_witness_from(ma, kind, index, lane, j, sup))
        if verdict == "unknown":
            unknown.append(name)
    if unknown:
        return EquivReport(verdict=UNKNOWN, unknown=tuple(unknown))
    return EquivReport(verdict=EQUIVALENT)


def prove_equivalent(a: ir.PimProgram, b: ir.PimProgram, *, inputs=None,
                     outputs=None, max_inputs: int = DEFAULT_MAX_INPUTS,
                     assume_control: bool = True) -> EquivReport:
    """Statically prove two same-shape programs equivalent.

    The contract is sound by construction: EQUIVALENT is only returned
    when every compared component's truth tables match exactly over the
    union support (never from an approximation), and every DIFFERENT
    verdict ships a :class:`Witness` whose assignment provably
    distinguishes the programs under ``isa.run_program`` (replay it with
    :func:`check_witness`). Anything the domain cannot decide — a value
    past the ``max_inputs``/table budget — is UNKNOWN, never EQUIVALENT.

    ``inputs`` restricts which rows are symbolic (others start constant
    0, matching a fresh subarray); ``outputs`` restricts the compared
    rows (default: every written row, the host-read values, and the
    DCC/migration side state)."""
    if (a.num_rows, a.words) != (b.num_rows, b.words):
        raise ValueError(
            f"cannot compare programs of different subarray shapes "
            f"{(a.num_rows, a.words)} vs {(b.num_rows, b.words)}")
    ik = _inputs_key(inputs, a.num_rows)
    ok = None if outputs is None else \
        tuple(sorted(int(r) % a.num_rows for r in outputs))
    key = ("prove", a.digest, a.payload_digest, b.digest, b.payload_digest,
           a.num_rows, a.words, ik, ok, max_inputs, assume_control)
    hit = _SEM_CACHE.get(key)
    if hit is not None:
        SEM_STATS["proof_hits"] += 1
        return hit
    SEM_STATS["proofs"] += 1
    ma = analyze(a, max_inputs=max_inputs, assume_control=assume_control,
                 inputs=ik)
    mb = analyze(b, max_inputs=max_inputs, assume_control=assume_control,
                 inputs=ik)
    return _cache_put(key, _compare_analyses(ma, mb, ok, max_inputs))


def check_witness(a: ir.PimProgram, b: ir.PimProgram, witness: Witness,
                  cfg: DDR3Timing = DEFAULT_TIMING, *, device=None) -> bool:
    """Execute both programs eagerly on the witness assignment (on
    ``device``: the card unless ``"cpu"``) and return True iff the claimed
    component really differs (the DIFFERENT contract's replay check)."""
    sa, reads_a = isa.run_on_bits(a, witness.as_bits(),
                                  control=witness.assume_control, cfg=cfg,
                                  device=device)
    sb, reads_b = isa.run_on_bits(b, witness.as_bits(),
                                  control=witness.assume_control, cfg=cfg,
                                  device=device)
    if witness.kind == "reads_len":
        return len(reads_a) != len(reads_b)
    if witness.kind == "read":
        return not torch.equal(reads_a[witness.index],
                               reads_b[witness.index])
    if witness.kind == "row":
        return not torch.equal(sa.bits[witness.index],
                               sb.bits[witness.index])
    assert witness.kind in ("dcc", "mig_top", "mig_bot"), witness.kind
    return not torch.equal(getattr(sa, witness.kind),
                           getattr(sb, witness.kind))


# ---------------------------------------------------------------------------
# Fusion verification (the compile.fuse verify_semantics gate)
# ---------------------------------------------------------------------------

def _interpret_segments(m: Analysis, program: ir.PimProgram,
                        segments) -> Analysis:
    """Abstractly execute a fused segment list with the exact semantics
    of ``exec._run_segments`` (incl. SegMaj's scratch writes and
    SegShiftRun's migration-row side state)."""
    from . import compile as pim_compile
    t0, t1, t2 = (int(t) % m.num_rows for t in (isa.T0, isa.T1, isa.T2))
    for seg in segments:
        if isinstance(seg, pim_compile.SegShiftRun):
            m.shift_chain(seg.src, seg.dst, int(seg.delta), int(seg.k))
        elif isinstance(seg, pim_compile.SegMaj):
            mj = m.maj(m.value(seg.a), m.value(seg.b), m.value(seg.c))
            for r in (t0, t1, t2, seg.dst):
                m.env[r] = mj
                m.written.add(r)
        elif isinstance(seg, pim_compile.SegNot):
            nv = m.not_(m.value(seg.src))
            m.dcc = nv
            m.env[seg.dst] = nv
            m.written.add(seg.dst)
        elif isinstance(seg, pim_compile.SegScan):
            for op in seg.ops:
                m.apply(op, program.payloads)
        elif isinstance(seg, pim_compile.SegHost):
            m.apply(seg.op, program.payloads)
        else:
            raise TypeError(seg)
    return m


def fusion_report(program: ir.PimProgram, segments=None, *,
                  max_inputs: int = DEFAULT_MAX_INPUTS,
                  assume_control: bool = True) -> EquivReport:
    """Prove the fused segment list (``compile.fuse(program)`` when not
    given) abstractly equivalent to the unfused op stream — full state:
    written rows, host reads, DCC and migration rows."""
    from . import compile as pim_compile
    if segments is None:
        segments = pim_compile.fuse(program)
    segments = tuple(segments)
    key = _cache_key("fusion", program, max_inputs, assume_control,
                     segments)
    hit = _SEM_CACHE.get(key)
    if hit is not None:
        SEM_STATS["proof_hits"] += 1
        return hit
    SEM_STATS["proofs"] += 1
    ma = analyze(program, max_inputs=max_inputs,
                 assume_control=assume_control)
    mb = Analysis(program.num_rows, program.words, max_inputs=max_inputs,
                  assume_control=assume_control)
    _interpret_segments(mb, program, segments)
    return _cache_put(key, _compare_analyses(ma, mb, None, max_inputs))


def verify_fusion(program: ir.PimProgram, segments=None, *,
                  max_inputs: int = DEFAULT_MAX_INPUTS,
                  assume_control: bool = True) -> EquivReport:
    """``fusion_report`` that RAISES :class:`EquivalenceError` unless the
    fused form is *provably* equivalent (UNKNOWN also raises: the gate
    promises a proof, not an absence of counterexamples)."""
    report = fusion_report(program, segments, max_inputs=max_inputs,
                           assume_control=assume_control)
    if report.verdict != EQUIVALENT:
        raise EquivalenceError(report)
    return report
