"""int8 error-feedback gradient compression (port of
``repro.optim.grad_compress``):

    s = max|g + residual| / 127,  q = round(g / s) clipped to ±127
    residual' = g − q s

``round`` is half to even, as ``jnp.round``. The reference's
``psum_compressed`` is a ``shard_map`` collective over a mesh; the port
runs on one card and has no counterpart of it yet.
"""
from __future__ import annotations

import torch


def compress(g, residual=None):
    """→ (codes int8, scale float32 0-d, new residual float32)."""
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    codes = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return codes, scale, gf - codes.to(torch.float32) * scale


def decompress(codes, scale):
    return codes.to(torch.float32) * scale


def compress_tree(grads, residuals=None):
    """Tensor by tensor over a list; returns (codes, scales, residuals)."""
    if residuals is None:
        residuals = [None] * len(grads)
    out = [compress(g, r) for g, r in zip(grads, residuals)]
    return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out])


def decompress_tree(codes, scales):
    return [decompress(c, s) for c, s in zip(codes, scales)]
