"""Shared building blocks: norms, RoPE, initializers, linear (incl. PIM-quant).

Port of ``repro.models.common``. Parameters live in ``nn.Module``s: every
float leaf (weights, norms, biases, a quantized linear's float32 scales) is
an ``nn.Parameter``, built frozen for serving (``models.trainable`` turns
the gradient on, as the reference's ``adamw.partition`` trains every
floating leaf); the int8 codes are buffers and never train. The functions
take those modules where the reference takes parameter dicts. Weights keep
the reference's layouts: a linear's weight is (d_in, d_out) and is applied
as ``x @ w``.
"""
from __future__ import annotations

import math
import sys

import torch
from torch import nn

from ..kernels.pim_matmul import ops as _pim

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def frozen(t: torch.Tensor | None):
    """A tensor as a parameter that takes no gradient until training asks
    for one (``models.trainable``)."""
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


def sinusoidal_pos_emb(positions, d_model: int):
    """float32 (..., d_model): the sines of ``positions`` times the
    frequencies ``10000^(-i/half)`` in the first half, their cosines in the
    second."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Linear — dense or the paper's bit-plane PIM-quantized path
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """A dense weight ``w`` (d_in, d_out), or int8 codes ``w_int``
    (d_in, d_out), a buffer, with float32 per-output ``scales``, a
    parameter; an optional bias ``b``. Training's backward reads the
    transposed codes (``codes_t``), built at its first call and kept as the
    non-persistent buffer ``w_int_t``."""

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
            self.scales = frozen(scales)
        self.b = frozen(b)

    @property
    def quantized(self) -> bool:
        return "w_int" in self._buffers

    def codes_t(self) -> torch.Tensor:
        """The codes transposed, (d_out, d_in) int8, built once."""
        if getattr(self, "w_int_t", None) is None:
            self.register_buffer("w_int_t", self.w_int.T.contiguous(),
                                 persistent=False)
        return self.w_int_t


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
                            bits=cfg.quant_bits, out_dtype=x.dtype,
                            codes_t=p.codes_t)
    else:
        y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


# ---------------------------------------------------------------------------
# The sharded path: sharding constraints and explicit redistributions
# ---------------------------------------------------------------------------

# Every explicit redistribution of the sharded path, by (where, op, shape,
# placements before, after): its count. XLA's partitioner makes these
# silently; DTensor refuses, so the port makes them and the dry-run
# reports them (``redistributed_views``). Plain tensors never reach it.
REDISTRIBUTED: dict = {}


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False, at no import, where
    ``torch.distributed.tensor`` was never loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x, spec):
    """The reference's ``with_sharding_constraint``: a plain tensor is
    returned unchanged; a DTensor is redistributed to ``spec``'s placements
    (``launch.sharding.placements``) on its own mesh."""
    if not is_dtensor(x):
        return x
    from ..launch.sharding import placements
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def redistribute(x, after, where: str, op: str):
    """A DTensor redistributed to the placements ``after``; a change of
    placements is recorded in ``REDISTRIBUTED``."""
    before = tuple(x.placements)
    if tuple(after) != before:
        key = (where, op, tuple(x.shape), str(before), str(tuple(after)))
        REDISTRIBUTED[key] = REDISTRIBUTED.get(key, 0) + 1
    return x.redistribute(x.device_mesh, tuple(after))


def hold(x, where: str):
    """A DTensor's pending sums (``Partial``: a row-parallel product's
    output) reduced to ``Replicate``; its gradient the same way in the
    backward, so that the sums of a column-parallel product's input grads
    are reduced where they arise (Megatron's f and g). A plain tensor is
    returned unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return redistribute(x, [Replicate() if p.is_partial() else p
                       for p in x.placements], where, "reduce")


def hold_batch(x, where: str):
    """The residual stream at a layer boundary: its batch dim sharded over
    the mesh's ("pod", "data") dims, the rest replicated, forward and
    backward (what XLA's propagation keeps from the batch's sharding and
    DTensor's per-op choices do not). A plain tensor is returned
    unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    dp = [i for i, n in enumerate(mesh.mesh_dim_names) if n in ("pod", "data")]
    ways = math.prod(mesh.size(i) for i in dp)
    after = [Shard(0) if i in dp and x.shape[0] % ways == 0 else Replicate()
             for i in range(mesh.ndim)]
    return redistribute(x, after, where, "hold")


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor it runs on each
    device's shard (``local_map``: DTensor has no rule for some
    elementwise ops, such as ``log_sigmoid_forward``)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map
    x = hold(x, "elementwise")
    return local_map(fn, out_placements=(x.placements,),
                     in_placements=(x.placements,),
                     device_mesh=x.device_mesh)(x)


def pad(x, pads, value: float = 0.0):
    """``F.pad(x, pads, value=value)`` (constant). On a DTensor the pads
    are concatenated blocks of ``value`` (DTensor's rule for the pad fails
    in some versions)."""
    if not is_dtensor(x):
        return torch.nn.functional.pad(x, pads, value=value)
    for i in range(len(pads) // 2):
        dim = x.dim() - 1 - i
        parts = []
        for n in pads[2 * i:2 * i + 2]:
            shape = list(x.shape)
            shape[dim] = n
            parts.append(torch.full(shape, value, dtype=x.dtype) if n
                         else None)
        blocks = [b for b in (parts[0], x, parts[1]) if b is not None]
        if len(blocks) > 1:
            x = torch.cat(blocks, dim=dim)
    return x


def gather_dims(x, dims, where: str, op: str):
    """A DTensor with its shards along tensor ``dims`` gathered (those mesh
    dims replicated), recorded in ``REDISTRIBUTED``; a plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = {d % x.dim() for d in dims}
    after = [Replicate() if p.is_shard() and p.dim in dims else p
             for p in x.placements]
    if tuple(after) == tuple(x.placements):
        return x
    return redistribute(x, after, where, op)


def _reshape_dt(x, shape, where: str):
    shape = tuple(shape)
    keep = 0
    while keep < min(x.dim(), len(shape)) and x.shape[keep] == shape[keep]:
        keep += 1
    tail = 0
    while tail < min(x.dim(), len(shape)) - keep \
            and x.shape[-1 - tail] == shape[-1 - tail]:
        tail += 1
    ways: dict = {}
    for mesh_dim, p in enumerate(x.placements):
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * x.device_mesh.size(mesh_dim)
    # a sharded dim the view changes stays sharded only as the first dim
    # of a merge, or of a split whose first factor divides evenly
    bad = [d for d, n in ways.items() if keep <= d < x.dim() - tail and not (
        d == keep and keep < len(shape)
        and (shape[keep] >= x.shape[d] or shape[keep] % n == 0))]
    x = gather_dims(x, bad, where, "view")
    try:
        return x.reshape(shape)
    except RuntimeError as e:
        if "shard" not in str(e).lower():
            raise
    return gather_dims(x, range(keep, x.dim()), where, "view").reshape(shape)


class _Reshape(torch.autograd.Function):
    """A DTensor view, its gradient's view back to the input's shape made
    the same way."""

    @staticmethod
    def forward(ctx, x, shape, where):
        ctx.in_shape, ctx.where = tuple(x.shape), where
        return _reshape_dt(x, shape, where)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dt(g, ctx.in_shape, ctx.where + " grad"), None, None


def reshape(x, shape, where: str):
    """``x.reshape(shape)``. A DTensor whose sharding the view cannot carry
    (a dim split unevenly across its mesh dims, which XLA pads and DTensor
    refuses) has the dims the view changes gathered first, forward and
    backward."""
    if not is_dtensor(x):
        return x.reshape(shape)
    shape = tuple(shape)
    if -1 in shape:
        rest = math.prod(s for s in shape if s != -1)
        shape = tuple(x.numel() // rest if s == -1 else s for s in shape)
    return _Reshape.apply(x, shape, where)
