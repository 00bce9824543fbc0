"""Recorded PIM instruction-stream IR (numpy; a copy of the reference's
``repro.core.pim.ir`` that reads its row aliases from the port's ``isa``).

Instead of executing every ISA command eagerly (one Python-level pytree
transition per command), a :class:`ProgramBuilder` records the command stream
once into a :class:`PimProgram`. The program is then cost-modeled in a single
pass, optimized, fused, and executed as a compiled artifact
(``compile.py`` / ``exec.py``) — the trace-driven architecture of
HBM-PIMulator and SIMDRAM's μProgram abstraction.

The IR stores *primitive* commands only. Composite Ambit ops (AND/OR/XOR/
NOT/MAJ) are macro-expanded at record time into exactly the primitive
sequence ``isa.py`` executes, so a recorded program is command-for-command —
and therefore cost- and bit-identical — to the eager path. The eager ISA in
``isa.py`` is unchanged and remains the shim for old call-sites.

Row operands must be concrete Python ints at record time (negative aliases
like ``isa.T0`` resolve against ``num_rows``, as in the eager path).

Text traces (``to_trace`` / ``from_trace``) use an HBM-PIMulator-style
line-per-command format (see DESIGN.md §6) so external workloads can be
replayed through ``benchmarks/trace_replay.py``. Multi-bank (device-level)
streams serialize as ``pim-trace v2`` — a ``banks=N`` header plus
``BANK <b>`` line prefixes — via ``to_trace_banks``/``from_trace_banks``
(DESIGN.md §7); multi-subarray devices as ``pim-trace v3`` — an extra
``subarrays=S`` header field and ``BANK <b> SUB <s>`` prefixes — via
``to_trace_device``/``from_trace_device`` (DESIGN.md §8). v2/v3 HOSTW
payloads use an RLE zero-page encoding when shorter than plain hex.
Imports validate operands (row ranges, SHIFT delta) with line-numbered
errors instead of letting the executor mis-execute them.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable

import numpy as np

from . import isa
from .state import NUM_ROWS, ROW_WORDS

# Primitive opcodes. DRA copies like ROWCLONE but charges a 2-row MRA.
OP_ISSUE = "issue"
OP_ROWCLONE = "rowclone"
OP_DRA = "dra"
OP_TRA = "tra"
OP_NOT2DCC = "not_to_dcc"
OP_DCC2 = "dcc_to"
OP_SHIFT = "shift"
OP_WRITE = "write_row"
OP_READ = "read_row"
OP_FILL = "fill"          # zero-cost row init (reserve_control_rows)
OP_COPY = "copy"          # LISA row movement; dst may live in another
                          # subarray/bank (device addressing in delta/c)

# COPY's "destination = the slot carrying this stream" sentinel (delta = c =
# COPY_SELF). Programs recorded with it stay local on WHATEVER slot runs
# them — replicating one stream across banks keeps every copy in-bank —
# whereas explicit coordinates (including (0, 0)) always name that device
# slot.
COPY_SELF = -1


def copy_is_local(op: "PimOp") -> bool:
    """True iff a COPY executes inside the single subarray running it:
    self-addressed, or explicitly (0, 0) — which IS the only subarray on
    the eager/compiled paths. The device scheduler additionally treats a
    destination equal to the carrying slot as local (``schedule.py``)."""
    return (op.delta, op.c) in ((COPY_SELF, COPY_SELF), (0, 0))

# Columnar opcode encoding: the fixed integer code of every opcode. Order is
# part of the on-the-wire columnar layout (and of the program digest), so new
# opcodes append — never reorder.
OPCODES = (OP_ISSUE, OP_ROWCLONE, OP_DRA, OP_TRA, OP_NOT2DCC, OP_DCC2,
           OP_SHIFT, OP_WRITE, OP_READ, OP_FILL, OP_COPY)
OP_CODE = {name: i for i, name in enumerate(OPCODES)}

# How many columnar encodings (and digests) were built — regression tests
# assert warm caches never rebuild them.
COLUMN_STATS = {"builds": 0}


@dataclasses.dataclass(frozen=True)
class ProgramColumns:
    """Array-native view of one op stream: an ``(n_ops, 6)`` int64 table
    (columns ``code, a, b, c, delta, payload``; FILL words need the int64
    headroom) plus a 128-bit content digest. Built ONCE per program (at
    ``build``/``concat``/trace-import time, or lazily on first use) so the
    cost pass, fusion, and stream-group hashing all run on arrays instead
    of re-walking Python ``PimOp`` objects."""

    table: np.ndarray
    digest: bytes

    @property
    def code(self) -> np.ndarray:
        return self.table[:, 0]

    @property
    def a(self) -> np.ndarray:
        return self.table[:, 1]

    @property
    def b(self) -> np.ndarray:
        return self.table[:, 2]

    @property
    def c(self) -> np.ndarray:
        return self.table[:, 3]

    @property
    def delta(self) -> np.ndarray:
        return self.table[:, 4]

    @property
    def payload(self) -> np.ndarray:
        return self.table[:, 5]


def _build_columns(ops: tuple) -> ProgramColumns:
    COLUMN_STATS["builds"] += 1
    table = np.empty((len(ops), 6), np.int64)
    for i, o in enumerate(ops):
        table[i, 0] = OP_CODE[o.op]
        table[i, 1] = o.a
        table[i, 2] = o.b
        table[i, 3] = o.c
        table[i, 4] = o.delta
        table[i, 5] = o.payload
    table.setflags(write=False)
    digest = hashlib.blake2b(table.tobytes(), digest_size=16).digest()
    return ProgramColumns(table=table, digest=digest)


# Trace mnemonics (stable on-disk names), one line per command.
_MNEMONIC = {
    OP_ISSUE: "ISSUE", OP_ROWCLONE: "AAP", OP_DRA: "DRA", OP_TRA: "TRA",
    OP_NOT2DCC: "NOT2DCC", OP_DCC2: "DCC2", OP_SHIFT: "SHIFT",
    OP_WRITE: "HOSTW", OP_READ: "HOSTR", OP_FILL: "FILL", OP_COPY: "COPY",
}
_FROM_MNEMONIC = {v: k for k, v in _MNEMONIC.items()}


# -- HOSTW payload encoding (plain hex / RLE zero-page) -----------------------

def rle_encode_payload(row: np.ndarray) -> str:
    """Run-length encode a uint32 row as ``rle:`` + comma-joined tokens:
    ``<hex8>`` for a single word, ``<hex8>x<count>`` for a run. Multi-KB
    HOSTW payloads are mostly zero pages — runs collapse them to one token.
    """
    row = np.asarray(row, dtype=np.uint32)
    toks = []
    i = 0
    while i < row.size:
        j = i + 1
        while j < row.size and row[j] == row[i]:
            j += 1
        word = f"{int(row[i]):08x}"
        toks.append(word if j - i == 1 else f"{word}x{j - i}")
        i = j
    return "rle:" + ",".join(toks)


def decode_payload(tok: str, words: int) -> np.ndarray:
    """Decode a HOSTW payload field: plain little-endian hex or ``rle:``."""
    if not tok.startswith("rle:"):
        payload = np.frombuffer(bytes.fromhex(tok), dtype="<u4")
    else:
        out = []
        for t in tok[4:].split(","):
            word, _, count = t.partition("x")
            w = int(word, 16)
            if not 0 <= w < 2**32:
                raise ValueError(f"RLE word {word!r} is not a 32-bit value")
            out.extend([w] * (int(count) if count else 1))
        payload = np.asarray(out, dtype=np.uint32)
    if payload.shape != (words,):
        raise ValueError(
            f"HOSTW payload is {payload.size} words, "
            f"trace declares {words}")
    return payload.astype(np.uint32)


def _payload_field(row: np.ndarray, rle: bool) -> str:
    plain = np.asarray(row, dtype="<u4").tobytes().hex()
    if not rle:
        return plain
    enc = rle_encode_payload(row)
    return enc if len(enc) < len(plain) else plain


def _parse_operands(op: str, toks: list[str], payloads: "list[np.ndarray]",
                    words: int, num_rows: int, banks: int = 1,
                    subarrays: int = 1) -> "PimOp":
    """Decode one trace line's operands (mnemonic already resolved).

    Operands are validated here so a malformed trace fails at import, not as
    a silent mis-execution downstream: row indices must lie in
    ``[0, num_rows)`` (the executor would otherwise wrap them ``% num_rows``)
    and SHIFT's delta must be exactly ±1 (the migration-cell primitive moves
    one bit; ``_op_rows`` would quietly treat any positive delta as +1).
    """
    def row(tok: str) -> int:
        r = int(tok)
        if not 0 <= r < num_rows:
            raise ValueError(
                f"row index {r} out of range [0, {num_rows})")
        return r

    if op == OP_ISSUE:
        return PimOp(op)
    if op in (OP_ROWCLONE, OP_DRA):
        return PimOp(op, a=row(toks[1]), b=row(toks[2]))
    if op == OP_TRA:
        return PimOp(op, a=row(toks[1]), b=row(toks[2]), c=row(toks[3]))
    if op == OP_NOT2DCC:
        return PimOp(op, a=row(toks[1]))
    if op == OP_DCC2:
        return PimOp(op, b=row(toks[1]))
    if op == OP_SHIFT:
        delta = int(toks[3])
        if delta not in (1, -1):
            raise ValueError(
                f"SHIFT delta must be +1 or -1 (1-bit migration-cell "
                f"primitive), got {delta:+d}")
        return PimOp(op, a=row(toks[1]), b=row(toks[2]), delta=delta)
    if op == OP_COPY:
        dst_bank, dst_sub = int(toks[3]), int(toks[4])
        if (dst_bank, dst_sub) != (COPY_SELF, COPY_SELF) and not (
                0 <= dst_bank < banks and 0 <= dst_sub < subarrays):
            raise ValueError(
                f"COPY destination ({dst_bank}, {dst_sub}) outside the "
                f"device ({banks} banks x {subarrays} subarrays); use "
                f"{COPY_SELF} {COPY_SELF} for a local (self-slot) copy")
        return PimOp(op, a=row(toks[1]), b=row(toks[2]), delta=dst_bank,
                     c=dst_sub)
    if op == OP_WRITE:
        payload = decode_payload(toks[2], words)
        out = PimOp(op, b=row(toks[1]), payload=len(payloads))
        payloads.append(payload)
        return out
    if op == OP_READ:
        return PimOp(op, a=row(toks[1]))
    assert op == OP_FILL, op
    return PimOp(op, b=row(toks[1]), payload=int(toks[2], 16))


@dataclasses.dataclass(frozen=True)
class PimOp:
    """One primitive command. ``a``/``b``/``c`` are absolute row indices
    (src, dst, third TRA row); ``delta`` is the shift direction; ``payload``
    indexes ``PimProgram.payloads`` for WRITE and holds the fill word for
    FILL.

    COPY (LISA row movement) reuses ``delta``/``c`` as the *destination's
    device coordinates* ``(dst_bank, dst_sub)``; the source is always the
    slot whose stream carries the op. ``(COPY_SELF, COPY_SELF)`` addresses
    the carrying slot itself — a local copy on whatever slot runs the
    stream; explicit coordinates (including ``(0, 0)``) always name that
    device slot."""

    op: str
    a: int = 0
    b: int = 0
    c: int = 0
    delta: int = 0
    payload: int = -1

    def reads(self) -> tuple[int, ...]:
        if self.op in (OP_ROWCLONE, OP_DRA, OP_NOT2DCC, OP_SHIFT, OP_READ,
                       OP_COPY):
            return (self.a,)
        if self.op == OP_TRA:
            return (self.a, self.b, self.c)
        return ()

    def writes(self) -> tuple[int, ...]:
        if self.op in (OP_ROWCLONE, OP_DRA, OP_DCC2, OP_SHIFT, OP_WRITE,
                       OP_FILL):
            return (self.b,)
        if self.op == OP_COPY:
            # Cross-slot copies write another subarray's row, not a local one.
            return (self.b,) if copy_is_local(self) else ()
        if self.op == OP_TRA:
            return (self.a, self.b, self.c)
        return ()


@dataclasses.dataclass(frozen=True)
class PimProgram:
    """An immutable recorded command stream for one subarray shape.

    Immutability covers the ``payloads`` data: the executor's uploaded
    payload rows and the scheduler's identity-keyed payload cache key on it
    never changing.
    ``ProgramBuilder.write_row`` and :meth:`with_payloads` snapshot (copy)
    the rows for you; constructing a ``PimProgram`` directly with arrays
    you keep writing to is a caller bug."""

    ops: tuple[PimOp, ...]
    num_rows: int = NUM_ROWS
    words: int = ROW_WORDS
    payloads: tuple[np.ndarray, ...] = ()

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def columns(self) -> ProgramColumns:
        """Cached columnar encoding (see :class:`ProgramColumns`). Lazily
        built on first access and memoized on the (frozen) instance —
        ``build``/``concat``/trace import warm it eagerly so downstream
        passes never pay the per-op walk twice."""
        cols = getattr(self, "_columns", None)
        if cols is None:
            cols = _build_columns(self.ops)
            object.__setattr__(self, "_columns", cols)
        return cols

    @property
    def digest(self) -> bytes:
        """Stable 128-bit content hash of the op stream (payload *data*
        excluded — that is the stream-group contract). O(1) after the
        columnar encoding is built."""
        return self.columns.digest

    @property
    def payload_digest(self) -> bytes:
        """Stable 128-bit hash of the HOSTW payload *contents* (sizes +
        bits), memoized on the instance. The op-stream :attr:`digest`
        deliberately excludes payload data (the stream-group contract),
        but semantic verdicts (``sem.py``) depend on it — HOSTW bits are
        constants in the truth-table domain — so content-keyed caches
        pair both digests."""
        pd = getattr(self, "_payload_digest", None)
        if pd is None:
            h = hashlib.blake2b(digest_size=16)
            for p in self.payloads:
                h.update(np.int64(p.size).tobytes())
                h.update(np.ascontiguousarray(p, dtype=np.uint32).tobytes())
            pd = h.digest()
            object.__setattr__(self, "_payload_digest", pd)
        return pd

    def with_payloads(self, payloads) -> "PimProgram":
        """Same command stream, different HOSTW payload data (the stream-
        group pattern: one recorded step, per-bank/per-step data). Shares
        this program's cached columnar encoding — no op re-walk, no
        re-hash. The rows are snapshotted (copied), like
        ``ProgramBuilder.write_row``: programs are immutable, and the
        executor's uploaded rows and the scheduler's identity-keyed
        payload cache rely on recorded data never changing under them."""
        out = PimProgram(
            ops=self.ops, num_rows=self.num_rows, words=self.words,
            payloads=tuple(np.array(p, dtype=np.uint32, copy=True)
                           for p in payloads))
        object.__setattr__(out, "_columns", self.columns)
        return out

    @property
    def trace_lines(self) -> tuple[int, ...] | None:
        """Per-op source line numbers when this program was imported from
        a pim-trace text (``from_trace_*``), else ``None``. Provenance
        only — attached outside the dataclass fields so equality, hashing
        and the columnar digest are unaffected; the lint pass uses it to
        anchor diagnostics to trace lines."""
        return getattr(self, "_trace_lines", None)

    @property
    def n_reads(self) -> int:
        return sum(1 for o in self.ops if o.op == OP_READ)

    def counts(self) -> dict:
        """Static per-opcode histogram (exact, no execution)."""
        out: dict[str, int] = {}
        for o in self.ops:
            out[o.op] = out.get(o.op, 0) + 1
        return out

    @property
    def host_bytes(self) -> int:
        """Off-chip bytes this stream moves: HOSTW payloads + HOSTR rows.
        The number the in-DRAM COPY path drives to zero."""
        n = sum(int(p.size) * 4 for p in self.payloads)
        return n + self.n_reads * self.words * 4

    # -- trace import/export --------------------------------------------------
    def _format_op(self, o: PimOp, rle: bool = False) -> str:
        m = _MNEMONIC[o.op]
        if o.op == OP_ISSUE:
            return m
        if o.op in (OP_ROWCLONE, OP_DRA):
            return f"{m} {o.a} {o.b}"
        if o.op == OP_TRA:
            return f"{m} {o.a} {o.b} {o.c}"
        if o.op == OP_NOT2DCC:
            return f"{m} {o.a}"
        if o.op == OP_DCC2:
            return f"{m} {o.b}"
        if o.op == OP_SHIFT:
            return f"{m} {o.a} {o.b} {o.delta:+d}"
        if o.op == OP_COPY:
            return f"{m} {o.a} {o.b} {o.delta} {o.c}"
        if o.op == OP_WRITE:
            return f"{m} {o.b} {_payload_field(self.payloads[o.payload], rle)}"
        if o.op == OP_READ:
            return f"{m} {o.a}"
        assert o.op == OP_FILL, o.op
        return f"{m} {o.b} {o.payload:08x}"

    def to_trace(self) -> str:
        lines = [f"# pim-trace v1 rows={self.num_rows} words={self.words}"]
        lines.extend(self._format_op(o) for o in self.ops)
        return "\n".join(lines) + "\n"

    @classmethod
    def from_trace(cls, text: str) -> "PimProgram":
        programs = from_trace_banks(text)
        if len(programs) != 1:
            raise ValueError(
                f"trace holds {len(programs)} banks; use "
                "from_trace_banks for multi-bank (pim-trace v2) traces")
        return programs[0]

    def save_trace(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_trace())

    @classmethod
    def load_trace(cls, path) -> "PimProgram":
        with open(path) as f:
            return cls.from_trace(f.read())


def to_trace_banks(programs: "Iterable[PimProgram]") -> str:
    """Export per-bank programs as a ``pim-trace v2`` text.

    Every command line carries a ``BANK <b>`` prefix; the header records the
    bank count. All banks must share one subarray shape (the device model's
    invariant). Single-program exports stay ``to_trace`` (v1) — v2 is the
    superset format for device-level streams. HOSTW payloads use the RLE
    zero-page encoding whenever it is shorter than plain hex.
    """
    programs = list(programs)
    assert programs, "need at least one per-bank program"
    rows, words = programs[0].num_rows, programs[0].words
    for p in programs:
        assert (p.num_rows, p.words) == (rows, words), \
            "banks must share one subarray shape"
    lines = [f"# pim-trace v2 rows={rows} words={words} "
             f"banks={len(programs)}"]
    for b, p in enumerate(programs):
        lines.extend(f"BANK {b} {p._format_op(o, rle=True)}" for o in p.ops)
    return "\n".join(lines) + "\n"


def to_trace_device(programs) -> str:
    """Export per-``(bank, subarray)`` programs as a ``pim-trace v3`` text.

    ``programs`` is a nested ``[bank][subarray]`` sequence (``None`` = idle
    slot); all banks must have the same subarray count and all programs one
    shape. Lines carry ``BANK <b> SUB <s>`` prefixes and the header records
    both axes. HOSTW payloads use the RLE zero-page encoding when shorter.
    """
    programs = [list(bank) for bank in programs]
    assert programs and programs[0], "need at least one bank with subarrays"
    subarrays = len(programs[0])
    assert all(len(bank) == subarrays for bank in programs), \
        "all banks must have the same subarray count"
    shapes = {(p.num_rows, p.words) for bank in programs for p in bank
              if p is not None}
    assert len(shapes) <= 1, "slots must share one subarray shape"
    rows, words = shapes.pop() if shapes else (NUM_ROWS, ROW_WORDS)
    lines = [f"# pim-trace v3 rows={rows} words={words} "
             f"banks={len(programs)} subarrays={subarrays}"]
    for b, bank in enumerate(programs):
        for s, p in enumerate(bank):
            if p is not None:
                lines.extend(f"BANK {b} SUB {s} {p._format_op(o, rle=True)}"
                             for o in p.ops)
    return "\n".join(lines) + "\n"


def _parse_trace(text: str):
    """Shared v1/v2/v3 parser → (per-slot ops/payloads, rows, words, banks,
    subarrays). Slot key = (bank, sub); unprefixed lines fall to (0, 0)."""
    num_rows, words, banks, subarrays = NUM_ROWS, ROW_WORDS, 1, 1
    ops: dict[tuple[int, int], list[PimOp]] = {}
    payloads: dict[tuple[int, int], list[np.ndarray]] = {}
    lines: dict[tuple[int, int], list[int]] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("//")[0].strip()
        if line.startswith("#"):
            if "pim-trace" in line:
                for tok in line.split():
                    if tok.startswith("rows="):
                        num_rows = int(tok[5:])
                    elif tok.startswith("words="):
                        words = int(tok[6:])
                    elif tok.startswith("banks="):
                        banks = int(tok[6:])
                        if banks < 1:
                            raise ValueError(
                                f"trace line {lineno}: banks={banks} "
                                "must be >= 1")
                    elif tok.startswith("subarrays="):
                        subarrays = int(tok[10:])
                        if subarrays < 1:
                            raise ValueError(
                                f"trace line {lineno}: subarrays="
                                f"{subarrays} must be >= 1")
            continue
        if not line:
            continue
        toks = line.split()
        if toks[0] == "PIM":      # HBM-PIMulator-style prefix is accepted
            toks = toks[1:]
        bank = sub = 0
        try:
            if toks and toks[0].upper() == "BANK":
                bank = int(toks[1])
                toks = toks[2:]
                if not 0 <= bank < banks:
                    raise ValueError(
                        f"bank {bank} out of range [0, {banks}) — is the "
                        "header's banks= count right?")
            if toks and toks[0].upper() == "SUB":
                sub = int(toks[1])
                toks = toks[2:]
                if not 0 <= sub < subarrays:
                    raise ValueError(
                        f"subarray {sub} out of range [0, {subarrays}) — "
                        "is the header's subarrays= count right?")
            name = toks[0].upper() if toks else ""
            if name not in _FROM_MNEMONIC:
                raise ValueError(f"unknown trace mnemonic {name!r}")
            op = _FROM_MNEMONIC[name]
            key = (bank, sub)
            ops.setdefault(key, []).append(_parse_operands(
                op, toks, payloads.setdefault(key, []), words, num_rows,
                banks, subarrays))
            lines.setdefault(key, []).append(lineno)
        except (IndexError, ValueError) as e:
            msg = "missing operand(s)" if isinstance(e, IndexError) else e
            raise ValueError(
                f"trace line {lineno} ({raw.strip()!r}): {msg}") from e

    def slot(b, s):
        prog = PimProgram(ops=tuple(ops.get((b, s), ())), num_rows=num_rows,
                          words=words,
                          payloads=tuple(payloads.get((b, s), ())))
        prog.columns            # warm the columnar encoding + digest once
        # Trace-line provenance for diagnostics (lint.py); attribute, not
        # a field, so program equality/digest semantics are untouched.
        object.__setattr__(prog, "_trace_lines",
                           tuple(lines.get((b, s), ())))
        return prog

    return slot, banks, subarrays


def from_trace_banks(text: str) -> tuple[PimProgram, ...]:
    """Parse a ``pim-trace`` text into per-bank programs.

    Accepts v1 (no ``BANK`` prefixes → one program) and v2 (``banks=N``
    header, ``BANK <b>`` prefixed command lines; unprefixed lines fall to
    bank 0). Multi-subarray (v3) traces are refused with a pointer to
    ``from_trace_device``. Malformed lines raise line-numbered errors.
    """
    slot, banks, subarrays = _parse_trace(text)
    if subarrays != 1:
        raise ValueError(
            f"trace declares {subarrays} subarrays per bank; use "
            "from_trace_device for multi-subarray (pim-trace v3) traces")
    return tuple(slot(b, 0) for b in range(banks))


def from_trace_device(text: str) -> tuple[tuple[PimProgram, ...], ...]:
    """Parse any ``pim-trace`` text into nested ``[bank][subarray]``
    programs (v1 → one bank/one subarray; v2 → N banks/one subarray)."""
    slot, banks, subarrays = _parse_trace(text)
    return tuple(tuple(slot(b, s) for s in range(subarrays))
                 for b in range(banks))


class ProgramBuilder:
    """Records the ISA surface into a :class:`PimProgram`.

    Method names and operand orders mirror ``isa.py`` minus the threaded
    state (``rowclone(src, dst)``, ``shift(src, dst, delta)``, ...), and the
    Ambit composites expand to the identical primitive sequences, so swapping
    ``isa.xxx(state, ...)`` for ``builder.xxx(...)`` records exactly the
    commands the eager path would execute.

    Operand validation matches the trace importers (``_parse_operands``)
    with op-index provenance: rows must lie in ``[-num_rows, num_rows)``
    (negative values alias the reserved tail, e.g. ``isa.T0``), SHIFT's
    delta must be exactly ±1, HOSTW payloads must be ``(words,)`` rows.
    ``verify=True`` needs the static verifier, which the port does not
    have yet: it raises ``NotImplementedError`` (ROADMAP A8).
    """

    def __init__(self, num_rows: int = NUM_ROWS, words: int = ROW_WORDS,
                 *, verify: bool = False):
        self.num_rows = int(num_rows)
        self.words = int(words)
        if verify:
            raise NotImplementedError(
                "verify=True needs the static verifier (lint.py), which the "
                "port does not have yet (ROADMAP A8)")
        self._ops: list[PimOp] = []
        self._payloads: list[np.ndarray] = []
        self._n_reads = 0

    def _resolve(self, r) -> int:
        if not isinstance(r, (int, np.integer)):
            raise TypeError(
                f"IR recording needs concrete int row indices, got {type(r)};"
                " use the eager isa.* path for traced row operands")
        r = int(r)
        if not -self.num_rows <= r < self.num_rows:
            # Same contract the trace importer enforces, with op-index
            # provenance; negatives down to -num_rows alias the reserved
            # tail (isa.C0/C1/T0..T3) and resolve modulo num_rows.
            raise ValueError(
                f"op {len(self._ops)}: row index {r} out of range "
                f"[{-self.num_rows}, {self.num_rows}) — negative rows "
                "alias the reserved control/scratch tail")
        return r % self.num_rows

    def __len__(self) -> int:
        return len(self._ops)

    def build(self) -> PimProgram:
        prog = PimProgram(ops=tuple(self._ops), num_rows=self.num_rows,
                          words=self.words, payloads=tuple(self._payloads))
        prog.columns            # warm the columnar encoding + digest once
        return prog

    # -- primitives -----------------------------------------------------------
    def issue(self) -> "ProgramBuilder":
        self._ops.append(PimOp(OP_ISSUE))
        return self

    def rowclone(self, src, dst) -> "ProgramBuilder":
        self._ops.append(PimOp(OP_ROWCLONE, a=self._resolve(src),
                               b=self._resolve(dst)))
        return self

    def dra(self, src, dst) -> "ProgramBuilder":
        self._ops.append(PimOp(OP_DRA, a=self._resolve(src),
                               b=self._resolve(dst)))
        return self

    def tra(self, r1, r2, r3) -> "ProgramBuilder":
        self._ops.append(PimOp(OP_TRA, a=self._resolve(r1),
                               b=self._resolve(r2), c=self._resolve(r3)))
        return self

    def not_to_dcc(self, src) -> "ProgramBuilder":
        self._ops.append(PimOp(OP_NOT2DCC, a=self._resolve(src)))
        return self

    def dcc_to(self, dst) -> "ProgramBuilder":
        self._ops.append(PimOp(OP_DCC2, b=self._resolve(dst)))
        return self

    def copy_row(self, src, dst, dst_bank: int = COPY_SELF,
                 dst_sub: int = COPY_SELF) -> "ProgramBuilder":
        """LISA row movement: ``dst`` row of slot ``(dst_bank, dst_sub)``
        <- ``src`` row of the slot executing this stream. The default
        destination is the *carrying slot itself* (``COPY_SELF``), so a
        stream replicated across banks keeps its copies local everywhere;
        explicit coordinates name a device slot and are only executable by
        the device scheduler (``schedule.py``), which drains cross-slot
        copies after the step's in-bank compute."""
        dst_bank, dst_sub = int(dst_bank), int(dst_sub)
        if (dst_bank, dst_sub) != (COPY_SELF, COPY_SELF) and (
                dst_bank < 0 or dst_sub < 0):
            raise ValueError(
                f"COPY destination ({dst_bank}, {dst_sub}) must be "
                f"non-negative coordinates, or ({COPY_SELF}, {COPY_SELF}) "
                "for the carrying slot")
        self._ops.append(PimOp(OP_COPY, a=self._resolve(src),
                               b=self._resolve(dst), delta=dst_bank,
                               c=dst_sub))
        return self

    def shift(self, src, dst, delta: int = +1) -> "ProgramBuilder":
        if delta not in (+1, -1):
            raise ValueError(
                f"op {len(self._ops)}: SHIFT delta must be +1 or -1 "
                f"(1-bit migration-cell primitive), got {delta:+d}")
        self._ops.append(PimOp(OP_SHIFT, a=self._resolve(src),
                               b=self._resolve(dst), delta=int(delta)))
        return self

    def write_row(self, dst, row) -> "ProgramBuilder":
        # snapshot (copy) the payload: programs are immutable, and both the
        # executor's uploaded rows and the scheduler's identity-keyed
        # payload cache rely on the recorded data never changing under them
        row = np.array(row, dtype=np.uint32, copy=True)
        if row.shape != (self.words,):
            raise ValueError(
                f"op {len(self._ops)}: HOSTW payload shape {row.shape} "
                f"!= ({self.words},)")
        self._ops.append(PimOp(OP_WRITE, b=self._resolve(dst),
                               payload=len(self._payloads)))
        self._payloads.append(row)
        return self

    def read_row(self, src) -> int:
        """Record a host read; returns the read slot index into
        ``ExecResult.reads``."""
        self._ops.append(PimOp(OP_READ, a=self._resolve(src)))
        slot = self._n_reads
        self._n_reads += 1
        return slot

    def fill(self, dst, word: int) -> "ProgramBuilder":
        """Zero-cost row init with a repeated 32-bit word (setup, not a DRAM
        command — mirrors ``reserve_control_rows`` mutating bits meter-free)."""
        self._ops.append(PimOp(OP_FILL, b=self._resolve(dst),
                               payload=int(word) & 0xFFFF_FFFF))
        return self

    def reserve_control_rows(self) -> "ProgramBuilder":
        return self.fill(isa.C0, 0).fill(isa.C1, 0xFFFF_FFFF)

    # -- composites (identical expansion to isa.py) ---------------------------
    def ambit_maj(self, a, b, c, dst) -> "ProgramBuilder":
        return (self.rowclone(a, isa.T0).rowclone(b, isa.T1)
                .rowclone(c, isa.T2).tra(isa.T0, isa.T1, isa.T2)
                .rowclone(isa.T0, dst))

    def ambit_and(self, a, b, dst) -> "ProgramBuilder":
        return self.ambit_maj(a, b, isa.C0, dst)

    def ambit_or(self, a, b, dst) -> "ProgramBuilder":
        return self.ambit_maj(a, b, isa.C1, dst)

    def ambit_not(self, src, dst) -> "ProgramBuilder":
        return self.not_to_dcc(src).dcc_to(dst)

    def ambit_xor(self, a, b, dst) -> "ProgramBuilder":
        scratch = {self._resolve(t)
                   for t in (isa.T0, isa.T1, isa.T2, isa.T3)}
        clash = {self._resolve(r) for r in (a, b, dst)} & scratch
        if clash:
            raise ValueError(
                f"ambit_xor operands alias its scratch rows {sorted(clash)}; "
                "the T0..T3 expansion would clobber them mid-sequence")
        return (self.ambit_or(a, b, isa.T3).ambit_and(a, b, dst)
                .ambit_not(dst, dst).ambit_and(isa.T3, dst, dst))

    # -- convenience ----------------------------------------------------------
    def shift_k(self, src, dst, k: int) -> "ProgramBuilder":
        """|k| repeated 1-bit shifts (k=0 degenerates to a copy), mirroring
        ``program.shift_k``."""
        if k == 0:
            return self.rowclone(src, dst)
        delta = 1 if k > 0 else -1
        self.shift(src, dst, delta)
        for _ in range(abs(k) - 1):
            self.shift(dst, dst, delta)
        return self


def record(fn, num_rows: int = NUM_ROWS, words: int = ROW_WORDS, *,
           verify: bool = False) -> PimProgram:
    """Run ``fn(builder)`` and return the recorded program. ``verify=True``
    raises ``NotImplementedError`` until lint is ported (ROADMAP A8)."""
    b = ProgramBuilder(num_rows, words, verify=verify)
    fn(b)
    return b.build()


def sequence_digest(digests: Iterable[bytes]) -> bytes:
    """Stable 128-bit digest of an ORDERED digest sequence — the O(1)
    identity of a concatenated or multi-phase stream, folded from the
    parts' cached 128-bit digests instead of re-hashing any op table."""
    h = hashlib.blake2b(digest_size=16)
    for d in digests:
        h.update(d)
    return h.digest()


def concat(programs: Iterable[PimProgram]) -> PimProgram:
    """Concatenate same-shape programs into one stream.

    Columnar fast path: the output's op table is stitched from the
    children's CACHED column tables (only WRITE payload indices are
    rebased), so concatenating warm programs never re-walks ops through
    ``_build_columns`` — ``ir.COLUMN_STATS`` stays flat on recurring
    multi-phase plans that fuse compute+gather streams every call."""
    programs = list(programs)
    assert programs, "need at least one program"
    if len(programs) == 1:
        return programs[0]
    rows, words = programs[0].num_rows, programs[0].words
    ops: list[PimOp] = []
    payloads: list[np.ndarray] = []
    tables: list[np.ndarray] = []
    write_code = OP_CODE[OP_WRITE]
    for p in programs:
        assert (p.num_rows, p.words) == (rows, words), "shape mismatch"
        off = len(payloads)
        table = p.columns.table
        if off and len(p.payloads):
            table = table.copy()
            table[table[:, 0] == write_code, 5] += off
            for o in p.ops:
                if o.op == OP_WRITE:
                    o = dataclasses.replace(o, payload=o.payload + off)
                ops.append(o)
        else:
            ops.extend(p.ops)
        tables.append(table)
        payloads.extend(p.payloads)
    table = np.concatenate(tables, axis=0)
    table.setflags(write=False)
    digest = hashlib.blake2b(table.tobytes(), digest_size=16).digest()
    out = PimProgram(ops=tuple(ops), num_rows=rows, words=words,
                     payloads=tuple(payloads))
    object.__setattr__(out, "_columns",
                       ProgramColumns(table=table, digest=digest))
    return out
