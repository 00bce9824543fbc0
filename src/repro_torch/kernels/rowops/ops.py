"""Public wrappers of the rowops kernels.

For a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/rowops.cu``) on the current stream, or raises; for a CPU tensor it
runs the plain torch version in ``ref.py``. There is no other switch: the
device of the input decides. ``interpret`` is accepted for signature parity
with the reference's Pallas wrappers and is ignored here.

``bitwise`` and ``shift_cols`` take and return separate (N, W) rows.
``bitwise_rows`` and ``shift_rows`` are the executor's entries: they take
a (B, R, W) slot state and row indices, and run a whole fused segment or
one-hop row (every source read, every destination, migration and DCC row
written) in one launch, in place.

``LAUNCHES`` counts kernel launches per wrapper (``LAUNCHES_BY_OP`` splits
``bitwise`` by op, ``ROWS_BY_OP`` ``bitwise_rows``, and ``SHIFT_ROUTES``
``shift_rows`` by route: out of place, in place, or in place through a
scratch row, which adds one row copy); a plain-version call counts
nothing. Launches recorded into a CUDA graph under capture run nothing:
``recorded`` takes them back out of the counts, so that the counts stay
launches that ran and a graph's replays move none of them.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from . import ref as _ref

LAUNCHES = {"shift_cols": 0, "bitwise": 0, "shift_rows": 0,
            "bitwise_rows": 0, "meter_fold": 0, "ripple_add": 0}
LAUNCHES_BY_OP = {op: 0 for op in _ref.OPS}
ROWS_BY_OP = {op: 0 for op in _ref.OPS}
SHIFT_ROUTES = {"out_of_place": 0, "in_place": 0, "scratch": 0}
_COUNTERS = {"launches": LAUNCHES, "by_op": LAUNCHES_BY_OP,
             "rows": ROWS_BY_OP, "routes": SHIFT_ROUTES}

_N_OPERANDS = {"not": 1, "and": 2, "or": 2, "xor": 2, "maj": 3}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_OP, ROWS_BY_OP, SHIFT_ROUTES):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def recorded(into: dict):
    """Within ``with``, the wrappers' launches are recorded into a CUDA
    graph under capture, not run: on exit every count is set back, and
    ``into`` gets what was recorded, ``(counter, key) -> count`` with
    counter ``launches``, ``by_op``, ``rows`` or ``routes`` (the graph's
    label, not a launch count)."""
    before = {(name, k): v for name, counts in _COUNTERS.items()
              for k, v in counts.items()}
    try:
        yield into
    finally:
        for (name, k), v in before.items():
            n = _COUNTERS[name][k] - v
            if n:
                into[(name, k)] = n
                _COUNTERS[name][k] = v


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
    _raise_on(_lib().rowops_bitwise(
        *ptrs, out.data_ptr(), a.numel(), _ref.OPS.index(op),
        torch.cuda.current_stream(a.device).cuda_stream), "bitwise")
    LAUNCHES["bitwise"] += 1
    LAUNCHES_BY_OP[op] += 1
    return out


def _check_state(name: str, bits: torch.Tensor, rows) -> bool:
    """Check a (B, R, W) int32 state and its row indices; True on the
    card, where the state must also be contiguous."""
    if bits.dtype != torch.int32:
        raise TypeError(f"{name}: rows must be int32 bit patterns, got "
                        f"{bits.dtype}")
    if bits.dim() != 3:
        raise ValueError(f"{name}: the state must be (B, R, W), got "
                         f"{tuple(bits.shape)}")
    for r in rows:
        if not 0 <= r < bits.shape[1]:
            raise ValueError(f"{name}: row {r} outside 0..{bits.shape[1]}")
    on_card = _on_card(bits)
    if on_card and not bits.is_contiguous():
        raise ValueError(f"{name}: the state must be contiguous")
    return on_card


def bitwise_rows(bits: torch.Tensor, op: str, srcs, dsts=(),
                 side: bool = False):
    """``op`` of rows ``srcs`` of every slot of the (B, R, W) state
    ``bits``, written to rows ``dsts`` (at most four) in place, in one
    launch: a fused MAJ (T0, T1, T2, dst), a TRA (its three operands), a
    NOT (its destination, and the DCC row as ``side``). A destination may
    be a source. Returns the result as a new (B, W) row when ``side``,
    else None."""
    if op not in _N_OPERANDS:
        raise ValueError(op)
    srcs, dsts = tuple(srcs), tuple(dsts)
    if len(srcs) != _N_OPERANDS[op]:
        raise ValueError(f"{op} needs {_N_OPERANDS[op]} source rows, got "
                         f"{len(srcs)}")
    if len(dsts) > 4 or not (dsts or side):
        raise ValueError(f"bitwise_rows writes 1-4 rows or a side row, got "
                         f"{len(dsts)} rows, side={side}")
    if not _check_state("bitwise_rows", bits, srcs + dsts):
        return _ref.ref_bitwise_rows(bits, op, srcs, dsts, side)
    n, r, w = bits.shape
    out = (torch.empty((n, w), dtype=torch.int32, device=bits.device)
           if side else None)
    if bits.numel() == 0:
        return out
    base, row = bits.data_ptr(), 4 * w
    ps = [base + s * row for s in srcs]
    ps += [ps[0]] * (3 - len(ps))              # unused operands: never read
    pd = [base + d * row for d in dsts] + [None] * (4 - len(dsts))
    side_ptr = None if out is None else out.data_ptr()
    _raise_on(_lib().rowops_bitwise_rows(
        *ps, *pd, len(dsts), side_ptr, n, w, r * w, _ref.OPS.index(op),
        torch.cuda.current_stream(bits.device).cuda_stream), "bitwise_rows")
    LAUNCHES["bitwise_rows"] += 1
    ROWS_BY_OP[op] += 1
    return out


@functools.cache
def shift_rows_cluster_words() -> int:
    """The longest row ``shift_rows`` shifts in place in one launch (one
    thread-block cluster per row); longer in-place rows take a scratch row
    and a copy."""
    return int(_lib().rowops_shift_rows_cluster_words())


def shift_rows(bits: torch.Tensor, src: int, dst: int, delta: int, k: int):
    """A k-hop migration-shift chain (direction ``delta`` = ±1) from row
    ``src`` to row ``dst`` of every slot of the (B, R, W) state ``bits``,
    in place, in one launch: ``dst`` gets the row shifted k columns, and
    the returned new (B, W) rows ``(mt, mb)`` are the migration cells of
    the last hop (the row shifted k - 1 columns, masked even / odd). ``src``
    may be ``dst``; |k - 1| beyond 32·W shifts everything out."""
    if delta not in (1, -1):
        raise ValueError(f"shift_rows: delta must be +1 or -1, got {delta}")
    k = int(k)
    if k < 1:
        raise ValueError(f"shift_rows: a chain has k >= 1 hops, got {k}")
    if not _check_state("shift_rows", bits, (src, dst)):
        return _ref.ref_shift_rows(bits, src, dst, delta, k)
    n, r, w = bits.shape
    mt = torch.empty((n, w), dtype=torch.int32, device=bits.device)
    mb = torch.empty((n, w), dtype=torch.int32, device=bits.device)
    if bits.numel() == 0:
        return mt, mb
    route, scratch = "out_of_place", None
    if src == dst:
        route = "in_place"
        if w > shift_rows_cluster_words():
            route = "scratch"
            scratch = torch.empty((n, w), dtype=torch.int32,
                                  device=bits.device)
    base, row = bits.data_ptr(), 4 * w
    _raise_on(_lib().rowops_shift_rows(
        base + src * row, base + dst * row, r * w, mt.data_ptr(),
        mb.data_ptr(), None if scratch is None else scratch.data_ptr(), n,
        w, min(k - 1, 32 * w), int(delta > 0),
        torch.cuda.current_stream(bits.device).cuda_stream), "shift_rows")
    LAUNCHES["shift_rows"] += 1
    SHIFT_ROUTES[route] += 1
    return mt, mb


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
