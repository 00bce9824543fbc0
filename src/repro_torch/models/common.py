"""Shared building blocks: norms, RoPE, initializers, linear (incl. PIM-quant).

Port of ``repro.models.common``. Parameters live in ``nn.Module``s (float
weights as frozen ``nn.Parameter``s, int8 codes and float32 scales as
buffers); the functions take those modules where the reference takes
parameter dicts. Weights keep the reference's layouts: a linear's weight is
(d_in, d_out) and is applied as ``x @ w``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.pim_matmul import ops as _pim

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def frozen(t: torch.Tensor | None):
    """A tensor as a parameter that takes no gradient (the port serves)."""
    return None if t is None else nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal weights of ``d_in ** -0.5`` scale, on ``gen``'s device."""
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float = 1e-6):
    """float32 math, cast to x's dtype, then ``* weight`` in that dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


def layernorm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(dt) * weight + bias


class Norm(nn.Module):
    """RMSNorm (``w``) or LayerNorm (``w`` and ``b``)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = frozen(w)
        self.b = frozen(b)


def make_norm_params(cfg, d: int, device) -> Norm:
    dt = dtype_of(cfg)
    w = torch.ones((d,), dtype=dt, device=device)
    if cfg.norm == "rmsnorm":
        return Norm(w)
    return Norm(w, torch.zeros((d,), dtype=dt, device=device))


def apply_norm(cfg, p: Norm, x):
    if p.b is not None:
        return layernorm(x, p.w, p.b)
    return rmsnorm(x, p.w)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: broadcastable to (..., S). The halves
    are not interleaved; the angles are float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.split(x.to(torch.float32), dh // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Linear — dense or the paper's bit-plane PIM-quantized path
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """A dense weight ``w`` (d_in, d_out), or int8 codes ``w_int``
    (d_in, d_out) with float32 per-output ``scales`` as buffers; an optional
    bias ``b``."""

    def __init__(self, w: torch.Tensor | None = None, *,
                 w_int: torch.Tensor | None = None,
                 scales: torch.Tensor | None = None,
                 b: torch.Tensor | None = None):
        super().__init__()
        if (w is None) == (w_int is None) or (w_int is None) != (
                scales is None):
            raise ValueError("Linear takes w, or w_int with scales")
        if w is not None:
            self.w = frozen(w)
        else:
            if w_int.dtype != torch.int8 or scales.dtype != torch.float32:
                raise TypeError(f"Linear: w_int int8 and scales float32, got "
                                f"{w_int.dtype} and {scales.dtype}")
            self.register_buffer("w_int", w_int)
            self.register_buffer("scales", scales)
        self.b = frozen(b)

    @property
    def quantized(self) -> bool:
        return "w_int" in self._buffers


def make_linear_params(gen, cfg, d_in: int, d_out: int, bias: bool = False,
                       quantize: bool = False) -> Linear:
    dt = dtype_of(cfg)
    w = dense_init(gen, d_in, d_out, dt)
    b = torch.zeros((d_out,), dtype=dt, device=gen.device) if bias else None
    if quantize and cfg.quant:
        w_int, scales = _pim.quantize(w.to(torch.float32), cfg.quant_bits)
        return Linear(w_int=w_int, scales=scales, b=b)
    return Linear(w, b=b)


def linear(cfg, p: Linear, x):
    """Apply a linear layer; a quantized one runs the bit-plane matmul of
    ``kernels/pim_matmul`` (the CUDA kernel for a CUDA tensor, its plain
    version on the CPU), the counterpart of the reference's
    ``pim_matmul_xla``."""
    if p.quantized:
        y = _pim.pim_linear(x.to(torch.bfloat16), p.w_int, p.scales,
                            mode=cfg.quant_mode,
                            bits=cfg.quant_bits, out_dtype=x.dtype)
    else:
        y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y
