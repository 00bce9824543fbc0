"""Flash attention with a memory-correct backward, as a
``torch.autograd.Function``.

Port of ``repro.models.flash`` (its ``jax.custom_vjp``). The forward is the
port's flash kernel (``kernels/flash_attn``: the CUDA kernel for a CUDA
tensor, its plain version on the CPU) asked for the log-sum-exp as well;
only (q, k, v, out, lse) are saved. The backward is the reference's
``_flash_bwd``, the FlashAttention-2 recurrence, in plain torch (the
reference's is plain jnp and reaches no Pallas kernel), chunked by the
reference's ``q_chunk`` / ``k_chunk``:

  delta = Σ dO∘O; per kv-chunk j, per q-chunk i:
      p  = exp(qkᵀ·scale − lse)
      dv_j += pᵀ dO ;  dp = dO vᵀ ;  ds = p∘(dp − delta)·scale
      dk_j += dsᵀ q ;  dq_i += ds k

Shapes follow ``attention.py``: q (B, Sq, KV, G, dh), k/v (B, Sk, KV,
dh|dv), pos_q (Sq,), pos_k (Sk,) or (B, Sk); the positions take no
gradient.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attn import ops as _flash

NEG_INF = -1e30


def _chunk(n: int, c: int) -> int:
    """The reference's chunk: ``min(c, n)``, halved until it divides n."""
    c = min(c, n)
    while n % c:
        c //= 2
    return c


def flash_backward(q, k, v, pos_q, pos_k, out, lse, dout, *, window, scale,
                   q_chunk: int, k_chunk: int):
    """(dq, dk, dv) in q's, k's and v's dtypes: the reference's
    ``_flash_bwd`` with float32 tiles and accumulators."""
    B, Sq, KV, G, dh = q.shape
    Sk, dv = k.shape[1], v.shape[-1]
    qc, kc = _chunk(Sq, q_chunk), _chunk(Sk, k_chunk)
    f32 = torch.float32
    doutf, outf = dout.to(f32), out.to(f32)
    delta = (doutf * outf).sum(-1).permute(0, 2, 3, 1)        # (B,KV,G,Sq)
    pk = (pos_k if pos_k.dim() == 2 else pos_k[None, :]).to(torch.int64)
    pq_all = pos_q.to(torch.int64)
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    dq = torch.zeros((B, Sq, KV, G, dh), dtype=f32, device=q.device)
    dk = torch.zeros((B, Sk, KV, dh), dtype=f32, device=q.device)
    dvv = torch.zeros((B, Sk, KV, dv), dtype=f32, device=q.device)
    for j in range(0, Sk, kc):
        kb, vb = kf[:, j:j + kc], vf[:, j:j + kc]
        pkb = pk[:, j:j + kc][:, None, None, None, :]
        dk_j = torch.zeros((B, kc, KV, dh), dtype=f32, device=q.device)
        dv_j = torch.zeros((B, kc, KV, dv), dtype=f32, device=q.device)
        for i in range(0, Sq, qc):
            qb, dob = qf[:, i:i + qc], doutf[:, i:i + qc]
            pqb = pq_all[i:i + qc][None, None, None, :, None]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            ok = (pkb >= 0) & (pkb <= pqb)
            if window is not None:
                ok &= (pqb - pkb) < window
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - lse[..., i:i + qc, None])        # (B,KV,G,qc,kc)
            dv_j = dv_j + torch.einsum("bkgqs,bqkgd->bskd", p, dob)
            dp = torch.einsum("bqkgd,bskd->bkgqs", dob, vb)
            ds = p * (dp - delta[..., i:i + qc, None]) * scale
            dk_j = dk_j + torch.einsum("bkgqs,bqkgd->bskd", ds, qb)
            dq[:, i:i + qc] += torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
        dk[:, j:j + kc] = dk_j
        dvv[:, j:j + kc] = dv_j
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: forward through the
    flash kernel with its log-sum-exp, backward by ``flash_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_k, window, scale, q_chunk,
                k_chunk):
        out, lse = _flash.flash_attention(q, k, v, pos_q, pos_k,
                                          window=window, scale=scale,
                                          return_lse=True)
        ctx.save_for_backward(q, k, v, pos_q, pos_k, out, lse)
        ctx.window, ctx.scale = window, scale
        ctx.q_chunk, ctx.k_chunk = q_chunk, k_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pos_q, pos_k, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(
            q, k, v, pos_q, pos_k, out, lse, dout, window=ctx.window,
            scale=ctx.scale, q_chunk=ctx.q_chunk, k_chunk=ctx.k_chunk)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, pos_q, pos_k, *, window=None, scale: float,
                    q_chunk: int = 512, k_chunk: int = 1024):
    """Differentiable flash attention: (B, Sq, KV, G, dv) in q's dtype."""
    return FlashAttention.apply(q, k, v, pos_q, pos_k, window, scale,
                                q_chunk, k_chunk)
