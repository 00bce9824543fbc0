"""In-DRAM SIMD arithmetic on horizontally-stored elements (paper §1, §8.0.1).

Port of ``repro.core.bitplane.arith``. The programs record exactly the
reference's command streams; the numpy oracles are copied.

Every routine is a PIM program over {AAP, TRA, NOT, SHIFT} — the carry wires
of a conventional adder become the paper's migration-cell shifts. Each has a
numpy oracle (``ref_*``) used by the tests.

Cost intuition (w = element width):
  ripple-carry add : w-1 shift rounds          (the paper's §8.0.1 RCA)
  Kogge-Stone add  : log2(w) rounds, but round d needs a d-column shift
                     = d chained 1-bit migration shifts, so total shift ops
                     are ~w; the win is in fewer TRA/XOR levels (§8.0.1)
  shift-and-add mul: w partial products, each needing a bit-smear (the
                     paper's §1 motivating workload)
"""
from __future__ import annotations

import numpy as np

from .vm import PimVM


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

def ref_add(a: np.ndarray, b: np.ndarray, width: int) -> np.ndarray:
    mask = (1 << width) - 1
    return (a.astype(np.uint64) + b.astype(np.uint64)) & mask


def ref_mul(a: np.ndarray, b: np.ndarray, width: int) -> np.ndarray:
    mask = (1 << width) - 1
    return (a.astype(np.uint64) * b.astype(np.uint64)) & mask


# ---------------------------------------------------------------------------
# Adders
# ---------------------------------------------------------------------------

def add_ripple(vm: PimVM, a: int, b: int, dst: int | None = None) -> int:
    """Ripple-carry: S,C iteration with the carry moved by a 1-bit shift."""
    s = vm.xor(a, b)
    c = vm.and_(a, b)
    for _ in range(vm.width - 1):
        cs = vm.shift_elem(c, +1)          # carry wire = migration shift
        vm.and_(s, cs, c)                  # next carry (uses pre-update S)
        vm.xor(s, cs, s)
        vm.free(cs)
    vm.free(c)
    if dst is not None:
        vm.copy(s, dst)
        vm.free(s)
        return dst
    return s


def add_kogge_stone(vm: PimVM, a: int, b: int, dst: int | None = None) -> int:
    """Kogge-Stone parallel-prefix adder (paper §8.0.1 future-work item)."""
    g = vm.and_(a, b)
    p = vm.xor(a, b)
    s0 = vm.copy(p)                         # keep propagate for the final sum
    d = 1
    while d < vm.width:
        gs = vm.shift_elem(g, +d)
        ps = vm.shift_elem(p, +d)
        t = vm.and_(p, gs)
        vm.or_(g, t, g)
        vm.and_(p, ps, p)
        vm.free(gs, ps, t)
        d *= 2
    carries = vm.shift_elem(g, +1)          # carry INTO bit i = G at bit i-1
    out = vm.xor(s0, carries, dst)
    vm.free(g, p, s0, carries)
    return out


# ---------------------------------------------------------------------------
# Shift-and-add multiplication (mod 2^width)
# ---------------------------------------------------------------------------

def mul_shift_add(vm: PimVM, a: int, b: int, dst: int | None = None,
                  adder=add_ripple) -> int:
    """acc += (a << j) for every set bit j of b (bit smeared into a lane mask),
    i.e. exactly the paper's §1 'shift-and-add multiplication ... repeated
    shift operations to align partial products before the accumulation'."""
    acc = vm.zero()
    ashift = vm.copy(a)
    for j in range(vm.width):
        bj = vm.and_(b, vm.mask(1 << j))
        lane = vm.smear(bj)
        part = vm.and_(ashift, lane)
        nxt = adder(vm, acc, part)
        vm.free(acc, bj, lane, part)
        acc = nxt
        if j != vm.width - 1:
            vm.shift_elem(ashift, +1, ashift)
    vm.free(ashift)
    if dst is not None:
        vm.copy(acc, dst)
        vm.free(acc)
        return dst
    return acc
