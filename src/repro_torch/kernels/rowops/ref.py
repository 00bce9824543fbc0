"""Plain torch versions of the rowops kernels (the oracles).

Rows are (N, W) int32 bit patterns: N independent DRAM rows of W packed
words; column c of a row = bit c%32 (little-endian) of word c//32 — the
convention of ``repro_torch.core.pim.state``. Logical right shifts are
masked by hand, since ``>>`` on int32 sign-extends.
"""
from __future__ import annotations

import numpy as np
import torch

OPS = ("not", "and", "or", "xor", "maj")


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (32 - s)) - 1)


def ref_bitwise(a, b=None, c=None, *, op: str):
    if op == "not":
        return ~a
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "maj":
        return (a & b) | (b & c) | (a & c)
    raise ValueError(op)


def ref_shift_cols(x: torch.Tensor, k: int) -> torch.Tensor:
    """Shift every row by k columns (+ = toward higher column), 0 fill;
    ``|k| >= 32·W`` shifts everything out."""
    if k == 0:
        return x.clone()
    w = x.shape[-1]
    kw, kb = divmod(abs(int(k)), 32)
    if kw >= w:
        return torch.zeros_like(x)

    def word_shift(v, up):
        if up == 0:
            return v
        pad = torch.zeros(v.shape[:-1] + (abs(up),), dtype=v.dtype,
                          device=v.device)
        if up > 0:
            return torch.cat([pad, v[..., :-up]], dim=-1)
        return torch.cat([v[..., -up:], pad], dim=-1)

    if k > 0:
        v = word_shift(x, kw)
        if kb:
            v = (v << kb) | _lsr(word_shift(v, 1), 32 - kb)
        return v
    v = word_shift(x, -kw)
    if kb:
        v = _lsr(v, kb) | (word_shift(v, -1) << (32 - kb))
    return v


# The migration masks (``repro_torch.core.pim.state.EVEN_MASK`` and
# ``ODD_MASK``) as int32 bit patterns.
EVEN_MASK = 0x5555_5555
ODD_MASK = 0xAAAA_AAAA - (1 << 32)


def ref_bitwise_rows(bits: torch.Tensor, op: str, srcs, dsts=(),
                     side: bool = False):
    """``op`` of rows ``srcs`` of every slot of the (B, R, W) state
    ``bits``, written to rows ``dsts`` in place (a destination may be a
    source: every source is read first); returns the result as a new
    (B, W) side row when ``side``, else None."""
    m = ref_bitwise(*(bits[:, r] for r in srcs), op=op)
    for r in dsts:
        bits[:, r] = m
    return m if side else None


def ref_shift_rows(bits: torch.Tensor, src: int, dst: int, delta: int,
                   k: int):
    """A k-hop migration-shift chain from row ``src`` to row ``dst`` of
    every slot, in place, as the reference's executor composes it: shift
    ``k - 1`` columns, capture the last hop's migration rows, merge them
    one column on. Returns the new (B, W) migration rows ``(mt, mb)``."""
    y = ref_shift_cols(bits[:, src], delta * (k - 1))
    mt = y & (EVEN_MASK if delta > 0 else ODD_MASK)
    mb = y & (ODD_MASK if delta > 0 else EVEN_MASK)
    bits[:, dst] = ref_shift_cols(mt, delta) | ref_shift_cols(mb, delta)
    return mt, mb


def ref_meter_fold(f_tab: torch.Tensor, i_tab: torch.Tensor,
                   f0: torch.Tensor, i0: torch.Tensor):
    """Sequential fold of ``(m, F)`` float32 / ``(m, G)`` int32 increment
    tables onto ``(B, F)`` / ``(B, G)`` starting values, row by row in table
    order: ``np.add.accumulate`` in float32, as ``compile.cost_pass`` does
    (never a cumsum or a sum, which may reorder or widen the adds)."""
    def fold(tab, init, dtype):
        t = tab.detach().cpu().numpy()
        x = init.detach().cpu().numpy()
        if len(t) == 0:
            out = x.copy()
        else:
            stack = np.concatenate(
                [x[None], np.broadcast_to(t[:, None, :],
                                          (len(t),) + x.shape)], axis=0)
            out = np.add.accumulate(stack, axis=0, dtype=dtype)[-1]
        return torch.from_numpy(np.ascontiguousarray(out)).to(init.device)
    return fold(f_tab, f0, np.float32), fold(i_tab, i0, np.int32)


def _interior_mask(width: int) -> int:
    """32-bit tile of the 'all element bits except bit 0' pattern, as a
    plain int. Valid whenever width divides 32 (1, 2, 4, 8, 16, 32)."""
    assert 32 % width == 0, "interior mask tiles only for width | 32"
    pat = 0
    for e in range(32 // width):
        pat |= (((1 << width) - 1) & ~1) << (e * width)
    return pat


def _as_int32(pattern: int) -> int:
    """A 32-bit pattern as the int32 value with the same bits."""
    return pattern - (1 << 32) if pattern >= 1 << 31 else pattern


def ref_ripple_add(a: torch.Tensor, b: torch.Tensor,
                   width: int) -> torch.Tensor:
    """Bulk element-wise add over horizontally packed w-bit elements, with
    the S/C iteration the PIM machine runs: ``width - 1`` rounds of
    ``cs = shift(c, +1) & interior; c = s & cs; s ^= cs``."""
    interior = _as_int32(_interior_mask(width))
    s = a ^ b
    c = a & b
    for _ in range(width - 1):
        cs = ref_shift_cols(c, +1) & interior
        c = s & cs
        s = s ^ cs
    return s


def composed_ripple_add(a: torch.Tensor, b: torch.Tensor, width: int, *,
                        bitwise=ref_bitwise,
                        shift_cols=ref_shift_cols) -> torch.Tensor:
    """The same add as the op-by-op sequence the fused kernel replaces:
    2 + 4*(width-1) ``bitwise``/``shift_cols`` calls. Pass the wrappers of
    ``ops`` to run it as that many kernel launches."""
    interior = torch.full_like(a, _as_int32(_interior_mask(width)))
    s = bitwise(a, b, op="xor")
    c = bitwise(a, b, op="and")
    for _ in range(width - 1):
        cs = bitwise(shift_cols(c, 1), interior, op="and")
        c = bitwise(s, cs, op="and")
        s = bitwise(s, cs, op="xor")
    return s
