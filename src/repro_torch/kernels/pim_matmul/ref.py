"""Plain torch versions of the bit-plane shift-and-add quantized matmul.

``ref_pim_matmul_raw`` is the plain version of the CUDA kernel in
``csrc/pim_matmul.cu`` (the function of the reference's Pallas
``pim_matmul_raw``): the CPU runs it, and ``chip_smoke.py`` holds the kernel
against it on the card. The others are the reference's oracles.
"""
from __future__ import annotations

import torch

MODES = ("shift_add", "dequant")


def plane_coeffs(bits: int):
    """Two's-complement plane weights: [1, 2, ..., -(2^(bits-1))]."""
    c = [float(1 << i) for i in range(bits - 1)]
    c.append(-float(1 << (bits - 1)))
    return c


def ref_planes(w_int: torch.Tensor, bits: int):
    """Decompose signed int8 weights into 0/1 bit planes (list of float32
    tensors): plane i is bit i of each code's two's complement, shifted
    out in the codes' own type (an arithmetic shift by i < 8 leaves bit i
    lowest), which moves a quarter of the bytes an int32 copy would."""
    return [((w_int >> i) & 1).to(torch.float32) for i in range(bits)]


def ref_dequant(w_int: torch.Tensor, scales: torch.Tensor,
                bits: int) -> torch.Tensor:
    """Reference dequantize: w_int * scale (per output channel)."""
    del bits
    return w_int.to(torch.float32) * scales[None, :].to(torch.float32)


def ref_pim_matmul(x, w_int, scales, bits: int) -> torch.Tensor:
    """Y = X @ dequant(W). Mathematically identical for both kernel modes:
    sum_b c_b (X @ plane_b) * scale == X @ (W_int * scale)."""
    return x.to(torch.float32) @ ref_dequant(w_int, scales, bits)


def ref_pim_matmul_planes(x, w_int, scales, bits: int) -> torch.Tensor:
    """Plane-by-plane evaluation (tests the shift-add decomposition itself)."""
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], w_int.shape[1]), dtype=torch.float32,
                      device=x.device)
    for coeff, plane in zip(plane_coeffs(bits), ref_planes(w_int, bits)):
        acc = acc + coeff * (xf @ plane)
    return acc * scales[None, :].to(torch.float32)


def ref_pim_matmul_raw(x, w_int, *, mode: str, bits: int) -> torch.Tensor:
    """Unscaled ``X @ W_int`` in float32, as the kernel computes it:
    ``shift_add`` sums ``c_b * (X @ plane_b)`` over the low ``bits`` bits of
    each code; ``dequant`` is one product with the codes as they are."""
    xf = x.to(torch.float32)
    if mode == "dequant":
        return xf @ w_int.to(torch.float32)
    if mode != "shift_add":
        raise ValueError(mode)
    acc = None
    for coeff, plane in zip(plane_coeffs(bits), ref_planes(w_int, bits)):
        term = coeff * (xf @ plane)
        acc = term if acc is None else acc + term
    return acc


def ref_quantize(w: torch.Tensor, bits: int):
    """Symmetric per-output-channel quantization to signed ``bits`` ints."""
    qmax = float((1 << (bits - 1)) - 1)
    absmax = torch.amax(torch.abs(w), dim=0)
    scales = torch.clamp(absmax, min=1e-8) / qmax
    w_int = torch.clamp(torch.round(w / scales[None, :]), -qmax - 1, qmax)
    return w_int.to(torch.int8), scales.to(torch.float32)
