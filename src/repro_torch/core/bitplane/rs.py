"""Reed-Solomon systematic encoding in-DRAM (paper §1, §8.0.2).

Port of ``repro.core.bitplane.rs``. The programs record exactly the
reference's command streams; the numpy oracles are copied.

SIMD layout: one *codeword per byte lane*, message symbols streamed across
*rows* (row i holds symbol i of every lane's message). The LFSR encoder state
is ``n_parity`` parity rows; each message row advances the LFSR with one
lane-wise GF(2^8) constant multiply per generator coefficient — all of it
{SHIFT, AND, XOR} PIM programs from ``gf.py``.

Oracle: plain numpy GF(256) polynomial-division encoder + syndrome check.
"""
from __future__ import annotations

import numpy as np

from .vm import PimVM
from . import gf

# --- GF(256) tables for the oracle -----------------------------------------
_EXP = np.zeros(512, dtype=np.uint64)
_LOG = np.zeros(256, dtype=np.uint64)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= gf.RS_POLY
_EXP[255:510] = _EXP[:255]


def _gf_mul_scalar(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[(int(_LOG[a]) + int(_LOG[b])) % 255])


def generator_poly(n_parity: int) -> list[int]:
    """g(x) = prod_{i=0}^{n_parity-1} (x - alpha^i); returns coeffs low→high,
    excluding the leading (monic) term."""
    g = [1]
    for i in range(n_parity):
        alpha_i = int(_EXP[i])
        nxt = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            nxt[j + 1] ^= c
            nxt[j] ^= _gf_mul_scalar(c, alpha_i)
        g = nxt
    return g[:-1]


def ref_rs_encode(msg: np.ndarray, n_parity: int) -> np.ndarray:
    """msg: (k, lanes) symbols. Returns (n_parity, lanes) parity symbols."""
    gcoef = generator_poly(n_parity)
    k, lanes = msg.shape
    parity = np.zeros((n_parity, lanes), dtype=np.uint64)
    for i in range(k):
        fb = (msg[i].astype(np.uint64) ^ parity[-1]) & 0xFF
        shifted = np.zeros_like(parity)
        shifted[1:] = parity[:-1]
        for j in range(n_parity):
            mul = np.array([_gf_mul_scalar(int(f), gcoef[j]) for f in fb],
                           dtype=np.uint64)
            shifted[j] ^= mul
        parity = shifted
    return parity


def ref_rs_syndromes(codeword: np.ndarray, n_parity: int) -> np.ndarray:
    """codeword: (n, lanes), highest-degree symbol first. All-zero iff valid."""
    codeword = np.asarray(codeword).astype(np.uint64)
    n, lanes = codeword.shape
    out = np.zeros((n_parity, lanes), dtype=np.uint64)
    for i in range(n_parity):
        alpha_i = int(_EXP[i])
        acc = np.zeros(lanes, dtype=np.uint64)
        for sym in codeword:
            acc = np.array([_gf_mul_scalar(int(a), alpha_i) for a in acc],
                           dtype=np.uint64) ^ sym
        out[i] = acc
    return out


def rs_syndromes(vm: PimVM, cw_rows: list[int], n_parity: int) -> list[int]:
    """In-DRAM syndrome evaluation: s_i = c(alpha^i), Horner over the
    codeword rows (highest-degree symbol first, matching
    ``ref_rs_syndromes``). Returns ``n_parity`` syndrome registers — all
    zero iff every lane's codeword is valid, so the XOR of syndrome rows
    across shards is a device-level integrity checksum."""
    assert vm.width == 8
    out = []
    for i in range(n_parity):
        alpha_i = int(_EXP[i])
        acc = vm.zero()
        for r in cw_rows:
            if alpha_i != 1:
                gf.gf_mul_const(vm, acc, alpha_i, acc, poly=gf.RS_POLY)
            vm.xor(acc, r, acc)
        out.append(acc)
    return out


def rs_encode(vm: PimVM, msg_rows: list[int], n_parity: int) -> list[int]:
    """In-DRAM LFSR encode. ``msg_rows``: registers holding symbol i of every
    lane (highest-degree first). Returns ``n_parity`` parity registers
    (parity[-1] = highest-degree parity symbol)."""
    assert vm.width == 8
    gcoef = generator_poly(n_parity)
    parity = [vm.zero() for _ in range(n_parity)]
    for r in msg_rows:
        fb = vm.xor(r, parity[-1])
        new_parity = []
        for j in range(n_parity):
            term = gf.gf_mul_const(vm, fb, gcoef[j], poly=gf.RS_POLY)
            if j > 0:
                vm.xor(term, parity[j - 1], term)
            new_parity.append(term)
        vm.free(fb, *parity)
        parity = new_parity
    return parity
