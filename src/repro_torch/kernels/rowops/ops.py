"""Public wrappers of the rowops kernels.

For a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/rowops.cu``) on the current stream, or raises; for a CPU tensor it
runs the plain torch version in ``ref.py``. There is no other switch: the
device of the input decides. ``interpret`` is accepted for signature parity
with the reference's Pallas wrappers and is ignored here.

``LAUNCHES`` counts kernel launches per wrapper (``LAUNCHES_BY_OP`` splits
``bitwise`` by op); a plain-version call counts nothing.
"""
from __future__ import annotations

import torch

from . import ref as _ref

LAUNCHES = {"shift_cols": 0, "bitwise": 0, "meter_fold": 0, "ripple_add": 0}
LAUNCHES_BY_OP = {op: 0 for op in _ref.OPS}

_N_OPERANDS = {"not": 1, "and": 2, "or": 2, "xor": 2, "maj": 3}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_OP):
        for k in counts:
            counts[k] = 0


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"rowops kernels take CUDA or CPU tensors, got "
                     f"{x.device}")


def _check_rows(name: str, x: torch.Tensor, like: torch.Tensor | None = None):
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: rows must be int32 bit patterns, got "
                        f"{x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: rows must be (N, W), got {tuple(x.shape)}")
    if like is not None and (x.shape != like.shape
                             or x.device != like.device):
        raise ValueError(f"{name}: operand {tuple(x.shape)} on {x.device} "
                         f"does not match {tuple(like.shape)} on "
                         f"{like.device}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _lib():
    from .. import _build
    return _build.load("rowops")


def shift_cols(x: torch.Tensor, k: int, *,
               interpret: bool | None = None) -> torch.Tensor:
    """Shift every (N, W) row by ``k`` columns (+ = toward higher column),
    zero fill; the result is a new tensor."""
    _check_rows("shift_cols", x)
    if not _on_card(x):
        return _ref.ref_shift_cols(x, k)
    if not x.is_contiguous():
        raise ValueError("shift_cols: rows must be contiguous")
    n, w = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    k = max(-32 * w, min(32 * w, int(k)))      # beyond ±32W: all zeros
    _raise_on(_lib().rowops_shift_cols(
        x.data_ptr(), out.data_ptr(), n, w, k,
        torch.cuda.current_stream(x.device).cuda_stream), "shift_cols")
    LAUNCHES["shift_cols"] += 1
    return out


def bitwise(a: torch.Tensor, b: torch.Tensor | None = None,
            c: torch.Tensor | None = None, *, op: str,
            interpret: bool | None = None) -> torch.Tensor:
    """Elementwise ``not/and/or/xor/maj`` over (N, W) rows; a new tensor."""
    if op not in _N_OPERANDS:
        raise ValueError(op)
    args = [a, b, c][:_N_OPERANDS[op]]
    if any(x is None for x in args):
        raise ValueError(f"{op} needs {len(args)} operands")
    _check_rows("bitwise", a)
    for x in args[1:]:
        _check_rows("bitwise", x, like=a)
    if not _on_card(a):
        return _ref.ref_bitwise(*args, op=op)
    if not all(x.is_contiguous() for x in args):
        raise ValueError("bitwise: rows must be contiguous")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    ptrs = [x.data_ptr() for x in args]
    ptrs += [ptrs[0]] * (3 - len(ptrs))        # unused operands: never read
    vec4 = int(a.numel() % 4 == 0
               and all(p % 16 == 0 for p in ptrs + [out.data_ptr()]))
    _raise_on(_lib().rowops_bitwise(
        *ptrs, out.data_ptr(), a.numel(), _ref.OPS.index(op), vec4,
        torch.cuda.current_stream(a.device).cuda_stream), "bitwise")
    LAUNCHES["bitwise"] += 1
    LAUNCHES_BY_OP[op] += 1
    return out


def meter_fold(f_tab: torch.Tensor, i_tab: torch.Tensor, f0: torch.Tensor,
               i0: torch.Tensor):
    """Fold ``(m, F)`` float32 and ``(m, G)`` int32 increment tables onto
    ``(B, F)`` / ``(B, G)`` starting values, strictly in table order.
    Returns new ``(B, F)``, ``(B, G)`` tensors."""
    if f_tab.dtype != torch.float32 or f0.dtype != torch.float32:
        raise TypeError("meter_fold: float tables must be float32")
    if i_tab.dtype != torch.int32 or i0.dtype != torch.int32:
        raise TypeError("meter_fold: int tables must be int32")
    if (f_tab.dim() != 2 or i_tab.dim() != 2 or f0.dim() != 2
            or i0.dim() != 2 or f_tab.shape[0] != i_tab.shape[0]
            or f_tab.shape[1] != f0.shape[1] or i_tab.shape[1] != i0.shape[1]
            or f0.shape[0] != i0.shape[0]):
        raise ValueError(
            f"meter_fold: shapes {tuple(f_tab.shape)}, {tuple(i_tab.shape)},"
            f" {tuple(f0.shape)}, {tuple(i0.shape)} do not fit")
    devices = {t.device for t in (f_tab, i_tab, f0, i0)}
    if len(devices) != 1:
        raise ValueError(f"meter_fold: operands on {sorted(map(str, devices))}")
    if not _on_card(f0):
        return _ref.ref_meter_fold(f_tab, i_tab, f0, i0)
    if not all(t.is_contiguous() for t in (f_tab, i_tab, f0, i0)):
        raise ValueError("meter_fold: operands must be contiguous")
    fout, iout = torch.empty_like(f0), torch.empty_like(i0)
    if f0.numel() + i0.numel() == 0:
        return fout, iout
    _raise_on(_lib().rowops_meter_fold(
        f_tab.data_ptr(), i_tab.data_ptr(), f0.data_ptr(), i0.data_ptr(),
        fout.data_ptr(), iout.data_ptr(), f_tab.shape[0], f0.shape[0],
        f0.shape[1], i0.shape[1],
        torch.cuda.current_stream(f0.device).cuda_stream), "meter_fold")
    LAUNCHES["meter_fold"] += 1
    return fout, iout


def ripple_add(a: torch.Tensor, b: torch.Tensor, *, width: int,
               interpret: bool | None = None) -> torch.Tensor:
    """Lane-wise ``a + b`` (mod 2**width) of horizontally packed w-bit
    elements in (N, W) rows: what the S/C carry iteration of the plain
    version computes, as one masked add per word on the card; ``width``
    must divide 32. A new tensor."""
    width = int(width)
    if width < 1 or 32 % width:
        raise ValueError(f"ripple_add: width {width} does not divide 32")
    _check_rows("ripple_add", a)
    _check_rows("ripple_add", b, like=a)
    if not _on_card(a):
        return _ref.ref_ripple_add(a, b, width)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ripple_add: rows must be contiguous")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    vec4 = int(all(p % 16 == 0 for p in ptrs))  # the kernel adds any tail
    _raise_on(_lib().rowops_ripple_add(
        *ptrs, a.numel(), width, vec4,
        torch.cuda.current_stream(a.device).cuda_stream), "ripple_add")
    LAUNCHES["ripple_add"] += 1
    return out
