"""The in-DRAM PIM command ISA, eager, on torch tensors.

Port of ``repro.core.pim.isa``: the plain oracle the compiled path is held
to, on the CPU and on the card. Primitive commands (each advances the DDR3
cost meter):

    rowclone(src, dst)            AAP — intra-subarray copy (RowClone-FPM)
    tra(r1, r2, r3)               triple-row activation → MAJ3, destructive
    dra(src, dst)                 dual-row activation (RowClone variant)
    not_to_dcc(src) / dcc_to(dst) Ambit NOT via the dual-contact-cell row
    shift(src, dst, delta=±1)     THE PAPER'S PRIMITIVE — 4 AAPs through the
                                  two migration rows
    write_row / read_row          host <-> row buffer (burst energy)

Composite Ambit ops are built from primitives (costs emerge from the
sequence). Every command is functional: it returns a new state and never
writes into the tensors of the state it was given. Row indices are Python
ints (negative aliases resolve against ``num_rows``); a state may carry a
leading slot axis, and a command then applies to every slot.

Row-address map: data rows 0..R-1 are ``state.bits``; rows R-1 = C0 (all
zeros) and R-2 = C1 (all ones) are the Ambit control rows, rows R-3..R-6
the Ambit scratch (T0..T3).
"""
from __future__ import annotations

import numpy as np
import torch

from .state import (EVEN_MASK, ODD_MASK, SubarrayState, as_rows,
                    make_subarray)
from .timing import (DDR3Timing, DEFAULT_TIMING, charge_aap, charge_burst,
                     charge_copy, charge_issue, charge_mra, charge_shift)

# Reserved row aliases (relative to num_rows R).
C0 = -1   # constant zeros
C1 = -2   # constant ones
T0 = -3   # scratch
T1 = -4
T2 = -5
T3 = -6   # extra scratch (survives ambit_maj, which clobbers T0..T2)


def resolve(state: SubarrayState, r) -> int:
    """Resolve possibly-negative row aliases to absolute indices."""
    return int(r) % state.num_rows


def _set_rows(bits: torch.Tensor, rows, row: torch.Tensor) -> torch.Tensor:
    """A copy of ``bits`` with each of ``rows`` set to ``row``."""
    out = bits.clone()
    for r in rows:
        out[..., r, :] = row
    return out


def reserve_control_rows(state: SubarrayState) -> SubarrayState:
    bits = state.bits.clone()
    bits[..., -1, :] = 0
    bits[..., -2, :] = -1          # 0xFFFFFFFF as an int32 bit pattern
    return _with(state, bits=bits)


# ---------------------------------------------------------------------------
# Row-level helpers (pure bit math on packed int32 rows)
# ---------------------------------------------------------------------------

def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by ``s`` in 1..31."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _word_shift(x: torch.Tensor, up: int) -> torch.Tensor:
    """Shift whole words along the row axis, 0 fill."""
    if up == 0:
        return x
    if abs(up) >= x.shape[-1]:       # whole row shifted out (e.g. fused k≥32W)
        return torch.zeros_like(x)
    pad = torch.zeros(x.shape[:-1] + (abs(up),), dtype=x.dtype,
                      device=x.device)
    if up > 0:
        return torch.cat([pad, x[..., :-up]], dim=-1)
    return torch.cat([x[..., -up:], pad], dim=-1)


def shift_row_words(row: torch.Tensor, delta: int) -> torch.Tensor:
    """Shift a packed row by ``delta`` columns (+1 = toward higher column).

    Little-endian bit order: +1 column == left shift within each word with
    the carry bit (bit 31) propagated into bit 0 of the *next* word. Edge
    bits fall off (fill 0)."""
    if delta == 0:
        return row
    kw, kb = divmod(abs(int(delta)), 32)
    if delta > 0:
        x = _word_shift(row, kw)
        if kb:
            x = (x << kb) | lsr(_word_shift(x, 1), 32 - kb)
        return x
    x = _word_shift(row, -kw)
    if kb:
        x = lsr(x, kb) | (_word_shift(x, -1) << (32 - kb))
    return x


def maj3_words(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    return (a & b) | (b & c) | (a & c)


# ---------------------------------------------------------------------------
# Primitive commands
# ---------------------------------------------------------------------------

def _with(state: SubarrayState, *, bits=None, mig_top=None, mig_bot=None,
          dcc=None, meter=None) -> SubarrayState:
    return SubarrayState(
        bits=state.bits if bits is None else bits,
        mig_top=state.mig_top if mig_top is None else mig_top,
        mig_bot=state.mig_bot if mig_bot is None else mig_bot,
        dcc=state.dcc if dcc is None else dcc,
        meter=state.meter if meter is None else meter,
    )


def rowclone(state: SubarrayState, src, dst,
             cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """AAP: dst <- src (src restored by the sense amps)."""
    row = state.bits[..., resolve(state, src), :]
    return _with(state, bits=_set_rows(state.bits, [resolve(state, dst)], row),
                 meter=charge_aap(state.meter, cfg))


def dra(state: SubarrayState, src, dst,
        cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """Dual-row activation copy variant (both rows end equal to src)."""
    row = state.bits[..., resolve(state, src), :]
    return _with(state, bits=_set_rows(state.bits, [resolve(state, dst)], row),
                 meter=charge_mra(state.meter, 2, cfg))


def tra(state: SubarrayState, r1, r2, r3,
        cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """Triple-row activation: all three rows <- MAJ(r1, r2, r3). Destructive."""
    idx = [resolve(state, r) for r in (r1, r2, r3)]
    m = maj3_words(*(state.bits[..., i, :] for i in idx))
    return _with(state, bits=_set_rows(state.bits, idx, m),
                 meter=charge_mra(state.meter, 3, cfg))


def not_to_dcc(state: SubarrayState, src,
               cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """Ambit NOT, phase 1: dcc <- ~src (charge crosses the DCC's n-port)."""
    row = state.bits[..., resolve(state, src), :]
    return _with(state, dcc=~row, meter=charge_aap(state.meter, cfg))


def dcc_to(state: SubarrayState, dst,
           cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """Ambit NOT, phase 2: dst <- dcc."""
    return _with(state,
                 bits=_set_rows(state.bits, [resolve(state, dst)], state.dcc),
                 meter=charge_aap(state.meter, cfg))


def shift(state: SubarrayState, src, dst, delta: int = +1,
          cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """THE PAPER'S PRIMITIVE: full-row 1-bit shift via the migration rows.

    Right shift (delta=+1), mirroring Fig. 3's 4-AAP sequence:
      AAP1  src -> mig_top  : top row captures the EVEN-column bits
      AAP2  src -> mig_bot  : bottom row captures the ODD-column bits
      AAP3  mig_top -> dst  : even bits re-emerge at their pair's odd bitline
      AAP4  mig_bot -> dst  : odd bits re-emerge one pair over; rows merge

    Left shift swaps which parity each migration row captures. Edge bits
    fall off (fill 0). ``delta`` must be ±1.
    """
    if delta not in (+1, -1):
        raise ValueError("the migration-cell shift moves exactly 1 bit")
    row = state.bits[..., resolve(state, src), :]
    if delta == +1:
        mig_top = row & EVEN_MASK            # AAP1: capture even columns
        mig_bot = row & ODD_MASK             # AAP2: capture odd columns
    else:
        mig_top = row & ODD_MASK             # AAP1: capture odd columns
        mig_bot = row & EVEN_MASK            # AAP2: capture even columns
    merged = (shift_row_words(mig_top, delta)     # AAP3: emerge via other port
              | shift_row_words(mig_bot, delta))  # AAP4: emerge + merge
    return _with(state, mig_top=mig_top, mig_bot=mig_bot,
                 bits=_set_rows(state.bits, [resolve(state, dst)], merged),
                 meter=charge_shift(state.meter, cfg))


def lisa_copy(state: SubarrayState, src, dst,
              cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """LISA row movement within this subarray: dst <- src at COPY timing
    (a distance-0 LISA copy costs exactly one AAP)."""
    row = state.bits[..., resolve(state, src), :]
    return _with(state, bits=_set_rows(state.bits, [resolve(state, dst)], row),
                 meter=charge_copy(state.meter, 0, False, cfg))


def write_row(state: SubarrayState, dst, row,
              cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """Host write: burst data onto the chip then restore into the row.
    ``row`` is a (words,) int32 tensor or a uint32 numpy row."""
    row = as_rows(row, state.device)
    meter = charge_burst(state.meter, state.words * 4, cfg)
    return _with(state, bits=_set_rows(state.bits, [resolve(state, dst)], row),
                 meter=meter)


def read_row(state: SubarrayState, src,
             cfg: DDR3Timing = DEFAULT_TIMING):
    """Host read: returns (state', row) and charges burst energy."""
    meter = charge_burst(state.meter, state.words * 4, cfg)
    return (_with(state, meter=meter),
            state.bits[..., resolve(state, src), :].clone())


def issue(state: SubarrayState,
          cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """Command-burst issue overhead (once per host-triggered burst)."""
    return _with(state, meter=charge_issue(state.meter, cfg))


# ---------------------------------------------------------------------------
# Composite Ambit ops (costs emerge from the primitive sequence)
# ---------------------------------------------------------------------------

def ambit_maj(state: SubarrayState, a, b, c, dst,
              cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """dst <- MAJ(a, b, c): 3 copies into scratch, TRA, copy out."""
    s = rowclone(state, a, T0, cfg)
    s = rowclone(s, b, T1, cfg)
    s = rowclone(s, c, T2, cfg)
    s = tra(s, T0, T1, T2, cfg)
    return rowclone(s, T0, dst, cfg)


def ambit_and(state: SubarrayState, a, b, dst,
              cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """dst <- a & b = MAJ(a, b, 0)."""
    return ambit_maj(state, a, b, C0, dst, cfg)


def ambit_or(state: SubarrayState, a, b, dst,
             cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """dst <- a | b = MAJ(a, b, 1)."""
    return ambit_maj(state, a, b, C1, dst, cfg)


def ambit_not(state: SubarrayState, src, dst,
              cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """dst <- ~src via the dual-contact-cell row (2 AAPs)."""
    return dcc_to(not_to_dcc(state, src, cfg), dst, cfg)


def ambit_xor(state: SubarrayState, a, b, dst,
              cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """dst <- a ^ b = (a | b) & ~(a & b). Uses T0..T3 as intermediates;
    no operand may resolve onto them (the expansion would clobber it)."""
    scratch = {t % state.num_rows for t in (T0, T1, T2, T3)}
    for name, r in (("a", a), ("b", b), ("dst", dst)):
        if int(r) % state.num_rows in scratch:
            raise ValueError(
                f"ambit_xor operand {name}={r} resolves onto scratch row "
                f"{int(r) % state.num_rows} (T0..T3) and would be clobbered "
                "mid-sequence")
    s = ambit_or(state, a, b, T3, cfg)       # T3 = a | b (T0..T2 are scratch)
    s = ambit_and(s, a, b, dst, cfg)         # dst = a & b
    s = ambit_not(s, dst, dst, cfg)          # dst = ~(a & b)
    return ambit_and(s, T3, dst, dst, cfg)   # dst = (a|b) & ~(a&b)


def run_program(state: SubarrayState, program,
                cfg: DDR3Timing = DEFAULT_TIMING, *,
                verify: bool = False):
    """Replay a recorded :class:`~.ir.PimProgram` command-at-a-time through
    this eager ISA. Returns ``(state, reads)``. Cross-slot COPYs have no
    meaning on one subarray and raise."""
    from . import ir

    if verify:
        raise NotImplementedError(
            "verify=True needs the static verifier (lint.py), which the "
            "port does not have yet (ROADMAP A8)")
    reads = []
    payload_rows: dict = {}
    for op in program.ops:
        if op.op == ir.OP_ISSUE:
            state = issue(state, cfg)
        elif op.op == ir.OP_ROWCLONE:
            state = rowclone(state, op.a, op.b, cfg)
        elif op.op == ir.OP_DRA:
            state = dra(state, op.a, op.b, cfg)
        elif op.op == ir.OP_TRA:
            state = tra(state, op.a, op.b, op.c, cfg)
        elif op.op == ir.OP_NOT2DCC:
            state = not_to_dcc(state, op.a, cfg)
        elif op.op == ir.OP_DCC2:
            state = dcc_to(state, op.b, cfg)
        elif op.op == ir.OP_SHIFT:
            state = shift(state, op.a, op.b, op.delta, cfg)
        elif op.op == ir.OP_COPY:
            if not ir.copy_is_local(op):
                raise ValueError(
                    f"cross-subarray COPY to ({op.delta}, {op.c}) needs the "
                    "device scheduler; the eager path runs one subarray")
            state = lisa_copy(state, op.a, op.b, cfg)
        elif op.op == ir.OP_WRITE:
            if op.payload not in payload_rows:
                payload_rows[op.payload] = as_rows(
                    program.payloads[op.payload], state.device)
            state = write_row(state, op.b, payload_rows[op.payload], cfg)
        elif op.op == ir.OP_READ:
            state, row = read_row(state, op.a, cfg)
            reads.append(row)
        elif op.op == ir.OP_FILL:
            word = int(np.uint32(op.payload).view(np.int32))
            bits = state.bits.clone()
            bits[..., resolve(state, op.b), :] = word
            state = _with(state, bits=bits)
        else:
            raise ValueError(op.op)
    return state, tuple(reads)


def run_on_bits(program, bits=None, *, control: bool = True,
                cfg: DDR3Timing = DEFAULT_TIMING, device=None):
    """Run a recorded program eagerly on a fresh subarray initialized with
    ``bits`` (``(num_rows, words)``, default all-zero). Returns
    ``(state, reads)``. ``control=True`` seeds C0/C1 first."""
    state = make_subarray(program.num_rows, program.words, bits,
                          device=device)
    if control:
        state = reserve_control_rows(state)
    return run_program(state, program, cfg)
