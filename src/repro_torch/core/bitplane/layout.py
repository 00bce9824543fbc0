"""Horizontal element layout for PIM bit-parallel arithmetic.

Port of ``repro.core.bitplane.layout``. Operands stay in the conventional
*horizontal* layout — a w-bit element occupies w consecutive bitlines.
Element ``e`` of a row lives at columns ``[e*w, (e+1)*w)``; column ``c`` is
bit ``c % 32`` of packed word ``c // 32`` (little-endian, matching
``pim.state``).

Packed rows are numpy uint32 arrays: they become HOSTW payloads of the
port's IR, which are numpy. ``unpack_elements`` also takes a row the port
read back, an int32 tensor on any device (its bits are kept by a dtype
view).
"""
from __future__ import annotations

import numpy as np
import torch


def pack_elements(values: np.ndarray, width: int, words: int) -> np.ndarray:
    """Pack integer elements (< 2**width) into a (words,) uint32 row."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[0]
    assert n * width <= words * 32, "row overflow"
    bits = np.zeros(words * 32, dtype=np.uint8)
    shifts = np.arange(width, dtype=np.uint64)
    bits[:n * width] = ((values[:, None] >> shifts) & 1).reshape(-1)
    packed = np.packbits(bits, bitorder="little")
    return packed.view("<u4").astype(np.uint32)


def _as_uint32(row) -> np.ndarray:
    if isinstance(row, torch.Tensor):
        return row.detach().cpu().numpy().view(np.uint32)
    return np.asarray(row).astype("<u4")


def unpack_elements(row, width: int, count: int) -> np.ndarray:
    """Inverse of ``pack_elements``: ``count`` uint64 elements."""
    row = np.ascontiguousarray(_as_uint32(row).astype("<u4"))
    bits = np.unpackbits(row.view(np.uint8), bitorder="little")
    assert count * width <= bits.size, "row underflow"
    mat = bits[:count * width].reshape(count, width).astype(np.uint64)
    return mat @ (np.uint64(1) << np.arange(width, dtype=np.uint64))


def _pattern_row(width: int, words: int, element_pattern: int) -> np.ndarray:
    """Tile a w-bit pattern across every element of the row."""
    n = (words * 32) // width
    vals = np.full(n, element_pattern, dtype=np.uint64)
    return pack_elements(vals, width, words)


def lsb_mask(width: int, words: int) -> np.ndarray:
    """Bit 0 of every element set."""
    return _pattern_row(width, words, 0b1)


def msb_mask(width: int, words: int) -> np.ndarray:
    """Bit w-1 of every element set."""
    return _pattern_row(width, words, 1 << (width - 1))


def interior_mask(width: int, words: int) -> np.ndarray:
    """All bits except bit 0 of each element (where shifted-in carries from a
    neighboring element would land after a +1 column shift)."""
    return _pattern_row(width, words, ((1 << width) - 1) & ~1)


def full_mask(width: int, words: int) -> np.ndarray:
    return _pattern_row(width, words, (1 << width) - 1)


def const_row(width: int, words: int, value: int) -> np.ndarray:
    """Every element = value (e.g. the GF(2^8) reduction pattern 0x1B)."""
    return _pattern_row(width, words, value)
