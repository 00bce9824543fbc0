"""Public API: quantize + pim_matmul + a drop-in linear layer.

``pim_linear`` is how the paper's technique enters the LM stack: every
quantized linear in ``repro_torch.models`` runs as a bit-plane matmul
(config.quant = "pim_w4" / "pim_w8", mode = "shift_add" | "dequant").

For a CUDA tensor ``pim_matmul`` launches a hand-written kernel
(``csrc/pim_matmul.cu``) on the current stream, or raises; for a CPU
tensor it runs the plain torch version in ``ref.py``. There is no other
switch: the device of the input decides whether a kernel runs, and
``route`` alone decides which one, from the shapes and X's type — never
from a failure (a launch that returns a CUDA error raises):

- ``"tensor_core"`` (``pim_matmul_tc``: bit planes built in registers,
  ``mma.sync`` on the tensor cores) for bf16 X with M >= ``TC_MIN_M``
  (prefill), K % 8 == 0 and N % 16 == 0 (rows of 16-byte multiples, for
  16-byte copies);
- ``"swap_ab"`` (``pim_matmul_swap``: the same planes as the A operand of
  Wᵀ·Xᵀ, the batch as the B operand, W streamed once into registers) for
  bf16 X with 1 <= M < ``TC_MIN_M`` (decode) and the same K and N;
- ``"cuda_core"`` (``pim_matmul``) otherwise: float32 X, rows that are not
  16-byte multiples.

Each picks its own tiles and K splits, so the reference's block sizes and
``interpret`` have no counterpart.

``LAUNCHES["pim_matmul"]`` counts kernel launches, ``ROUTES`` splits
them by route, ``SHAPES`` by (route, K, N) and ``KINDS`` by the (mode,
bits) the kernel was given; a plain-version call counts nothing. A call
made while the current stream captures a CUDA graph runs nothing then: it
counts in ``CAPTURED``, ``CAPTURED_SHAPES`` and ``CAPTURED_KINDS`` instead,
and whoever replays the graph adds what it captured at each replay
(``count_replay``; ``serve.engine`` does), so that the counts stay
launches that ran.
"""
from __future__ import annotations

import torch

from ..._device import sm_count as _sm_count
from . import ref as _ref

LAUNCHES = {"pim_matmul": 0}
ROUTES = {"tensor_core": 0, "swap_ab": 0, "cuda_core": 0}
CAPTURED = dict.fromkeys(ROUTES, 0)
SHAPES: dict[tuple[str, int, int], int] = {}
CAPTURED_SHAPES: dict[tuple[str, int, int], int] = {}
KINDS: dict[tuple[str, int], int] = {}
CAPTURED_KINDS: dict[tuple[str, int], int] = {}
# The least M that takes the tensor-core kernel: prefill takes it, decode
# (M = batch) the swapped-operand kernel, which holds the batch in at most
# two n8 fragments, so TC_MIN_M must stay <= 17. On one H100 the swapped
# kernel is still ~2x faster at M = 16 (chip_smoke.py's `route threshold`
# line times the three routes at M 4, 8, 16 and 64; PERF.md).
TC_MIN_M = 17


def reset_launches() -> None:
    LAUNCHES["pim_matmul"] = 0
    for r in ROUTES:
        ROUTES[r] = 0
    SHAPES.clear()
    KINDS.clear()


def _add(counts: dict, key, n: int = 1) -> None:
    counts[key] = counts.get(key, 0) + n


def _count(which: str, shape: tuple[int, int] | None = None,
           kind: tuple[str, int] | None = None) -> None:
    """Count one launch of route ``which`` (at ``shape``, (K, N), of
    ``kind``, (mode, bits)), or one captured launch (a build of torch
    without CUDA has no capture to ask about)."""
    capturing = torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()
    if shape is not None:
        _add(CAPTURED_SHAPES if capturing else SHAPES, (which, *shape))
    if kind is not None:
        _add(CAPTURED_KINDS if capturing else KINDS, kind)
    if capturing:
        CAPTURED[which] += 1
        return
    LAUNCHES["pim_matmul"] += 1
    ROUTES[which] += 1


def count_replay(routes: dict, shapes: dict | None = None,
                 kinds: dict | None = None) -> None:
    """Count one replay of a graph that captured ``routes``, ``shapes``
    and ``kinds``, launches by route, by (route, K, N) and by (mode, bits)
    (``CAPTURED``, ``CAPTURED_SHAPES`` and ``CAPTURED_KINDS`` after its
    capture less before)."""
    for which, n in routes.items():
        LAUNCHES["pim_matmul"] += n
        ROUTES[which] += n
    for key, n in (shapes or {}).items():
        _add(SHAPES, key, n)
    for key, n in (kinds or {}).items():
        _add(KINDS, key, n)


def route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """Which kernel a card call of these sizes takes: for bf16 X with
    ``k % 8 == 0`` and ``n % 16 == 0``, "tensor_core" when ``m >=
    TC_MIN_M`` and "swap_ab" below; else "cuda_core"."""
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 16 == 0:
        return "tensor_core" if m >= TC_MIN_M else "swap_ab"
    return "cuda_core"


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"pim_matmul takes CUDA or CPU tensors, got {x.device}")


def quantize(w: torch.Tensor, bits: int):
    """Symmetric per-output-channel int quantization → (int8 codes, scales)."""
    return _ref.ref_quantize(w, bits)


def _lib():
    from .. import _build
    return _build.load("pim_matmul")


def _check(x, w_int, scales, mode, bits):
    if mode not in _ref.MODES:
        raise ValueError(f"pim_matmul: mode must be one of {_ref.MODES}, "
                         f"got {mode!r}")
    if bits not in (4, 8):
        raise ValueError(f"pim_matmul: bits must be 4 or 8, got {bits}")
    if x.dim() != 2 or w_int.dim() != 2 or scales.dim() != 1:
        raise ValueError(f"pim_matmul: x (M, K), w_int (K, N), scales (N,); "
                         f"got {tuple(x.shape)}, {tuple(w_int.shape)}, "
                         f"{tuple(scales.shape)}")
    if x.shape[1] != w_int.shape[0] or scales.shape[0] != w_int.shape[1]:
        raise ValueError(f"pim_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w_int.shape)} with {tuple(scales.shape)} "
                         "scales do not fit")
    if w_int.dtype != torch.int8:
        raise TypeError(f"pim_matmul: w_int must be int8, got {w_int.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"pim_matmul: x must be bf16 or float32, got "
                        f"{x.dtype}")
    devices = {t.device for t in (x, w_int, scales)}
    if len(devices) != 1:
        raise ValueError(f"pim_matmul: operands on "
                         f"{sorted(map(str, devices))}")


def pim_matmul(x: torch.Tensor, w_int: torch.Tensor, scales: torch.Tensor,
               *, mode: str = "shift_add",
               bits: int = 4) -> torch.Tensor:
    """Y = X @ (W_int · scale) via bit planes. x: (M, K), w_int: (K, N)
    int8, scales: (N,). Returns (M, N) float32."""
    _check(x, w_int, scales, mode, bits)
    if not _on_card(x):
        return (_ref.ref_pim_matmul_raw(x, w_int, mode=mode, bits=bits)
                * scales[None, :].to(torch.float32))
    # as the CPU branch and the reference: float32 scales, and the kernels
    # read row-major operands
    x, w_int = x.contiguous(), w_int.contiguous()
    scales = scales.to(torch.float32).contiguous()
    m, k = x.shape
    n = w_int.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    return _launch(x, w_int, scales, out, mode, bits, route(m, k, n, x.dtype))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w_int, scales, out, mode, bits, which, splits=None):
    """Launch the kernel of route ``which`` into ``out``; ``splits``
    overrides the kernel's own choice of K splits."""
    lib = _lib()
    m, k = x.shape
    n = w_int.shape[1]
    sms = _sm_count(x.device.index or 0)
    if which != "cuda_core":   # 16-byte loads (scales: the tensor cores')
        x, w_int, scales = _aligned(x), _aligned(w_int), _aligned(scales)
    if splits is None:
        if which == "tensor_core":
            splits = lib.pim_matmul_tc_splits(
                m, k, n, bits if mode == "shift_add" else 1, sms)
        elif which == "swap_ab":
            splits = lib.pim_matmul_swap_splits(m, k, n, bits, sms)
        else:
            splits = lib.pim_matmul_splits(m, k, n, bits, sms)
    workspace = (torch.empty((splits, m, n), dtype=torch.float32,
                             device=x.device) if splits > 1 else out)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), w_int.data_ptr(), scales.data_ptr(),
            out.data_ptr(), workspace.data_ptr(), m, k, n,
            _ref.MODES.index(mode), bits)
    if which == "tensor_core":
        rc = lib.pim_matmul_tc(*args, splits, stream)
    elif which == "swap_ab":
        rc = lib.pim_matmul_swap(*args, splits, stream)
    else:
        rc = lib.pim_matmul(*args, int(x.dtype == torch.bfloat16), splits,
                            stream)
    if rc != 0:
        raise RuntimeError(f"pim_matmul kernel launch failed ({which}): "
                           f"CUDA error {rc}")
    _count(which, (k, n), (mode, bits))
    return out


class PimMatmul(torch.autograd.Function):
    """``pim_matmul`` with the gradients of the reference's
    ``pim_matmul_xla`` (y = acc · scales, acc the unscaled float32
    bit-plane product; ``w_int`` takes none):

    - dx = (dy · scales) in bf16 @ w_intᵀ, float32, then bf16 (x's type):
      the same kernel on the transposed codes (whose bit planes are the
      transposed planes) with unit scales, in either mode;
    - dscales[n] = Σ_m dy[m, n] · acc[m, n], acc recomputed by the same
      kernel with unit scales (shift_add), or in dequant mode
      Σ_k dW[k, n] · w_int[k, n] with dW = xᵀ dy a plain bf16 matmul, as
      the reference leaves it to XLA.

    ``codes_t`` returns the transposed codes (N, K) int8, kept by the
    caller (``models.common.Linear``) so that they are built once."""

    @staticmethod
    def forward(ctx, x, scales, w_int, codes_t, mode, bits):
        ctx.save_for_backward(x, scales, w_int)
        ctx.codes_t, ctx.mode, ctx.bits = codes_t, mode, bits
        return pim_matmul(x, w_int, scales, mode=mode, bits=bits)

    @staticmethod
    def backward(ctx, dy):
        x, scales, w_int = ctx.saved_tensors
        mode, bits = ctx.mode, ctx.bits
        dy = dy.to(torch.float32)
        dx = dscales = None
        if ctx.needs_input_grad[0]:
            ones_k = torch.ones(w_int.shape[0], dtype=torch.float32,
                                device=x.device)
            dx = pim_matmul((dy * scales).to(torch.bfloat16), ctx.codes_t(),
                            ones_k, mode=mode, bits=bits).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if mode == "shift_add":
                ones_n = torch.ones(w_int.shape[1], dtype=torch.float32,
                                    device=x.device)
                acc = pim_matmul(x, w_int, ones_n, mode=mode, bits=bits)
                dscales = (dy * acc).sum(0)
            else:
                dw = x.to(torch.bfloat16).T @ dy.to(torch.bfloat16)
                dscales = (dw.to(torch.float32)
                           * w_int.to(torch.float32)).sum(0)
        return dx, dscales, None, None, None, None


def pim_linear(x, w_int, scales, *, mode: str = "shift_add", bits: int = 4,
               out_dtype=torch.bfloat16, codes_t=None) -> torch.Tensor:
    """Linear layer over arbitrary leading dims: (..., K) @ (K, N). When
    autograd records (training), through :class:`PimMatmul`; ``codes_t``
    then returns the transposed codes (built here when not given)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scales.requires_grad):
        if codes_t is None:
            def codes_t():
                return w_int.T.contiguous()
        y = PimMatmul.apply(x2, scales, w_int, codes_t, mode, bits)
    else:
        y = pim_matmul(x2, w_int, scales, mode=mode, bits=bits)
    return y.reshape(*lead, -1).to(out_dtype)
