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
