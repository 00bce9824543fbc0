"""Feed-forward: the dense FFN (SwiGLU / GELU / GeGLU).

Port of the dense part of ``repro.models.ffn``; MoE waits (ROADMAP A10).
Dense FFNs route through ``common.linear``, so the paper's PIM bit-plane
quantized path (cfg.quant) applies transparently. The reference's
``jax.nn.gelu`` defaults to the tanh approximation, and so does the port.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .common import linear, make_linear_params


class DenseFFN(nn.Module):
    """``w1`` and ``w2``, and ``w3`` for the gated activations."""

    def __init__(self, w1, w2, w3=None):
        super().__init__()
        self.w1, self.w2, self.w3 = w1, w2, w3


def init_dense_ffn(gen, cfg, d_ff: int, quantize: bool = True) -> DenseFFN:
    D = cfg.d_model
    bias = cfg.mlp_bias
    w1 = make_linear_params(gen, cfg, D, d_ff, bias, quantize)
    if cfg.act in ("swiglu", "geglu"):
        w3 = make_linear_params(gen, cfg, D, d_ff, bias, quantize)
        w2 = make_linear_params(gen, cfg, d_ff, D, bias, quantize)
        return DenseFFN(w1, w2, w3)
    return DenseFFN(w1, make_linear_params(gen, cfg, d_ff, D, bias, quantize))


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def dense_ffn(cfg, p: DenseFFN, x):
    if cfg.act == "swiglu":
        return linear(cfg, p.w2, F.silu(linear(cfg, p.w1, x))
                      * linear(cfg, p.w3, x))
    if cfg.act == "geglu":
        return linear(cfg, p.w2, _gelu(linear(cfg, p.w1, x))
                      * linear(cfg, p.w3, x))
    return linear(cfg, p.w2, _gelu(linear(cfg, p.w1, x)))
