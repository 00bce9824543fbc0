"""Galois-field GF(2^8) arithmetic in-DRAM (paper §1, §8.0.2).

Port of ``repro.core.bitplane.gf``. The programs record exactly the
reference's command streams; the numpy oracles are copied.

AES's field: GF(2^8) mod x^8 + x^4 + x^3 + x + 1 (0x11B). The primitive the
paper highlights: ``xtime`` (multiply by x) = one element-local shift plus a
conditional XOR with 0x1B — i.e. exactly {SHIFT, AND, XOR} on horizontal
data. Full GF multiply is 8 xtime/accumulate rounds (Russian peasant), and
``gf_mul_const`` (the Reed-Solomon workhorse) is a fixed xtime/XOR chain.

Oracles use numpy log/antilog tables.
"""
from __future__ import annotations

import numpy as np

from .vm import PimVM

AES_POLY = 0x11B       # x^8+x^4+x^3+x+1 (AES; NB: 0x02 is NOT primitive here)
RS_POLY = 0x11D        # x^8+x^4+x^3+x^2+1 (Reed-Solomon; 0x02 primitive)
REDUCE_PATTERN = 0x1B


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

def ref_xtime(a: np.ndarray, poly: int = AES_POLY) -> np.ndarray:
    a = np.asarray(a).astype(np.uint64)
    red = np.where(a & 0x80, np.uint64(poly & 0xFF), np.uint64(0))
    return ((a << np.uint64(1)) ^ red) & np.uint64(0xFF)


def ref_gf_mul(a: np.ndarray, b: np.ndarray,
               poly: int = AES_POLY) -> np.ndarray:
    a = np.asarray(a).astype(np.uint64).copy()
    b = np.asarray(b).astype(np.uint64).copy()
    acc = np.zeros_like(a)
    for _ in range(8):
        acc ^= np.where(b & np.uint64(1), a, np.uint64(0))
        b >>= np.uint64(1)
        a = ref_xtime(a, poly)
    return acc & np.uint64(0xFF)


# ---------------------------------------------------------------------------
# PIM programs (element width must be 8)
# ---------------------------------------------------------------------------

def xtime(vm: PimVM, a: int, dst: int | None = None,
          poly: int = AES_POLY) -> int:
    assert vm.width == 8, "GF(2^8) routines use byte lanes"
    msb = vm.and_(a, vm.mask(0x80))
    lane = vm.smear(msb)                    # lanes whose MSB was set
    red = vm.and_(lane, vm.mask(poly & 0xFF))
    t = vm.shift_elem(a, +1)                # (a << 1) & 0xFF per lane
    out = vm.xor(t, red, dst)
    vm.free(msb, lane, red, t)
    return out


def gf_mul(vm: PimVM, a: int, b: int, dst: int | None = None,
           poly: int = AES_POLY) -> int:
    """Lane-wise GF(2^8) multiply, 8 Russian-peasant rounds."""
    assert vm.width == 8
    acc = vm.zero()
    av = vm.copy(a)
    for j in range(8):
        bj = vm.and_(b, vm.mask(1 << j))
        lane = vm.smear(bj)
        part = vm.and_(av, lane)
        vm.xor(acc, part, acc)
        vm.free(bj, lane, part)
        if j != 7:
            xtime(vm, av, av, poly=poly)
    vm.free(av)
    if dst is not None:
        vm.copy(acc, dst)
        vm.free(acc)
        return dst
    return acc


def gf_mul_const(vm: PimVM, a: int, const: int,
                 dst: int | None = None, poly: int = AES_POLY) -> int:
    """Lane-wise multiply by a compile-time GF constant: fixed xtime chain."""
    assert vm.width == 8 and 0 <= const < 256
    acc = vm.zero()
    av = vm.copy(a)
    c = const
    j = 0
    while c:
        if c & 1:
            vm.xor(acc, av, acc)
        c >>= 1
        if c:
            xtime(vm, av, av, poly=poly)
        j += 1
    vm.free(av)
    if dst is not None:
        vm.copy(acc, dst)
        vm.free(acc)
        return dst
    return acc


def aes_xtime_cost(vm_words: int = 2048, *, device=None) -> dict:
    """Static cost of one full-row xtime (for the crypto case-study bench),
    on ``device`` (the card unless ``device="cpu"``)."""
    vm = PimVM(width=8, num_rows=64, words=vm_words, device=device)
    a = vm.load(np.arange(vm.lanes) % 256)
    t0, e0 = vm.time_ns, vm.energy_nj
    xtime(vm, a)
    return {"time_ns": vm.time_ns - t0, "energy_nj": vm.energy_nj - e0,
            "bytes": vm.lanes}


# ---------------------------------------------------------------------------
# AES MixColumns — the paper's headline AES workload, fully in-DRAM
# ---------------------------------------------------------------------------

def ref_mixcolumns(state: np.ndarray) -> np.ndarray:
    """state: (..., 4) byte columns [a0..a3] → FIPS-197 MixColumns."""
    a = np.asarray(state).astype(np.uint64)
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x = ref_xtime
    b0 = x(a0) ^ (x(a1) ^ a1) ^ a2 ^ a3
    b1 = a0 ^ x(a1) ^ (x(a2) ^ a2) ^ a3
    b2 = a0 ^ a1 ^ x(a2) ^ (x(a3) ^ a3)
    b3 = (x(a0) ^ a0) ^ a1 ^ a2 ^ x(a3)
    return np.stack([b0, b1, b2, b3], axis=-1)


def _rot_lane_up(vm: PimVM, a: int) -> int:
    """Rotate byte lanes left within each 4-lane column group:
    [a0,a1,a2,a3] → [a1,a2,a3,a0]. Lane movement = 8/24-column migration
    shifts + group-boundary masks (host-written once, cached via load)."""
    n_groups = vm.lanes // 4
    lane3 = vm.load(np.array([0, 0, 0, 255] * n_groups))
    not_lane3 = vm.load(np.array([255, 255, 255, 0] * n_groups))
    down = vm.shift_cols(a, -8)             # lane i ← lane i+1 (all lanes)
    wrap = vm.shift_cols(a, +24)            # lane 3 ← lane 0 of same group
    keep = vm.and_(down, not_lane3)
    edge = vm.and_(wrap, lane3)
    out = vm.or_(keep, edge)
    vm.free(lane3, not_lane3, down, wrap, keep, edge)
    return out


def mixcolumns(vm: PimVM, a: int, dst: int | None = None) -> int:
    """Lane-wise AES MixColumns: bytes laid out [a0,a1,a2,a3] per column
    group. b = 2·a ⊕ 3·rot1(a) ⊕ rot2(a) ⊕ rot3(a), all via {SHIFT, AND,
    OR, XOR} — zero transposition, matching the paper's §1/§8 pitch."""
    assert vm.width == 8 and vm.lanes % 4 == 0
    r1 = _rot_lane_up(vm, a)
    r2 = _rot_lane_up(vm, r1)
    r3 = _rot_lane_up(vm, r2)
    x2 = xtime(vm, a)
    x2r1 = xtime(vm, r1)
    acc = vm.xor(x2, x2r1)
    vm.xor(acc, r1, acc)                     # 3·a1 = 2·a1 ⊕ a1
    vm.xor(acc, r2, acc)
    vm.xor(acc, r3, acc)
    vm.free(r1, r2, r3, x2, x2r1)
    if dst is not None:
        vm.copy(acc, dst)
        vm.free(acc)
        return dst
    return acc
