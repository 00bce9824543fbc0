"""Public API: quantize + pim_matmul + a drop-in linear layer.

``pim_linear`` is how the paper's technique enters the LM stack: every
quantized linear in ``repro_torch.models`` runs as a bit-plane matmul
(config.quant = "pim_w4" / "pim_w8", mode = "shift_add" | "dequant").

For a CUDA tensor ``pim_matmul`` launches the hand-written kernel
(``csrc/pim_matmul.cu``) on the current stream, or raises; for a CPU
tensor it runs the plain torch version in ``ref.py``. There is no other
switch: the device of the input decides. The kernel picks its own tiles
and takes any M, K and N, so the reference's block sizes and ``interpret``
have no counterpart.

``LAUNCHES["pim_matmul"]`` counts kernel launches; a plain-version call
counts nothing.
"""
from __future__ import annotations

import functools

import torch

from . import ref as _ref

LAUNCHES = {"pim_matmul": 0}


def reset_launches() -> None:
    LAUNCHES["pim_matmul"] = 0


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


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if not (x.is_contiguous() and w_int.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("pim_matmul: operands must be contiguous")
    if scales.dtype != torch.float32:
        raise TypeError(f"pim_matmul: scales must be float32, got "
                        f"{scales.dtype}")
    m, k = x.shape
    n = w_int.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _lib()
    splits = lib.pim_matmul_splits(m, k, n, bits,
                                   _sm_count(x.device.index or 0))
    workspace = (torch.empty((splits, m, n), dtype=torch.float32,
                             device=x.device) if splits > 1 else out)
    rc = lib.pim_matmul(
        x.data_ptr(), w_int.data_ptr(), scales.data_ptr(), out.data_ptr(),
        workspace.data_ptr(), m, k, n, _ref.MODES.index(mode), bits,
        int(x.dtype == torch.bfloat16), splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pim_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["pim_matmul"] += 1
    return out


def pim_linear(x, w_int, scales, *, mode: str = "shift_add", bits: int = 4,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Linear layer over arbitrary leading dims: (..., K) @ (K, N)."""
    lead = x.shape[:-1]
    y = pim_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w_int, scales,
                   mode=mode, bits=bits)
    return y.reshape(*lead, -1).to(out_dtype)
