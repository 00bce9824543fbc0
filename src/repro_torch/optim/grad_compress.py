"""int8 error-feedback gradient compression (port of
``repro.optim.grad_compress``):

    s = max|g + residual| / 127,  q = round(g / s) clipped to ±127
    residual' = g − q s

``round`` is half to even, as ``jnp.round``. ``psum_compressed`` is the
reference's ``shard_map`` building block as a ``torch.distributed``
collective over a process group (or one dim of a ``DeviceMesh``): the
scales' maximum, then the sum of the rescaled int32 codes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def compress(g, residual=None):
    """→ (codes int8, scale float32 0-d, new residual float32)."""
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual
    # over a 0-d tensor, not the Python float: CUDA divides by a host
    # scalar as a product with its reciprocal, which can miss the
    # correctly rounded quotient the reference takes by one ulp
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / torch.full(
        (), 127.0, dtype=torch.float32, device=gf.device)
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


def _process_group(group):
    """A ``ProcessGroup``, a ``(DeviceMesh, dim name)`` pair's group, or
    the default group for None."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    return group


def psum_compressed(g, group=None, residual=None):
    """int8-quantize, sum the codes in int32 across the group, rescale:
    the reference's arithmetic in its order. Scales are per participant,
    so the codes are first rescaled to the group's largest scale:

        smax  = max over the group of s          (all_reduce MAX)
        total = Σ round(q · (s / smax)) as int32  (all_reduce SUM)

    Returns (total float32 · smax, the new residual)."""
    pg = _process_group(group)
    codes, scale, new_residual = compress(g, residual)
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=pg)
    total = torch.round(codes.to(torch.float32) * (scale / smax)).to(
        torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=pg)
    return total.to(torch.float32) * smax, new_residual
