"""Plain torch version of the flash-attention forward: masked softmax.

It is the plain version of the CUDA kernels in ``csrc/flash_attn.cu``: the
CPU runs it, and ``chip_smoke.py`` holds both routes' kernels against it on
the card. It computes the reference's ``ref_flash_attention`` on the
models' layout, with a batch axis and per-row key positions:

  q (B, Sq, KV, G, dk) — query heads grouped by kv head (head h = kv·G + g
  reads kv head h // G); k (B, Sk, KV, dk); v (B, Sk, KV, dv); pos_q (Sq,);
  pos_k (B, Sk) or (Sk,), −1 marking an invalid key. A key is seen iff
  0 ≤ pos_k ≤ pos_q (and pos_q − pos_k < window); an unseen key scores
  −1e30. Returns (B, Sq, KV, G, dv) in q's dtype; the scores and the
  softmax are float32.

``split_kv_flash_attention`` is the split route's algorithm in the same
math, for the CPU tests of that algorithm; nothing on the main path calls
it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_scores(q, k, pos_q, pos_k, window, scale):
    """float32 scores (B, KV, G, Sq, Sk), unseen keys at −1e30."""
    B, dk = q.shape[0], q.shape[-1]
    scale = (dk ** -0.5) if scale is None else scale
    pk = pos_k if pos_k.dim() == 2 else pos_k[None, :].expand(B, -1)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    pq = pos_q[None, None, None, :, None]
    pkb = pk[:, None, None, None, :]
    ok = (pkb >= 0) & (pkb <= pq)
    if window is not None:
        ok &= (pq - pkb) < window
    return torch.where(ok, s, torch.full_like(s, NEG_INF))


def ref_flash_attention(q, k, v, pos_q, pos_k, *, window=None, scale=None):
    s = _masked_scores(q, k, pos_q, pos_k, window, scale)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.to(q.dtype)


def split_kv_flash_attention(q, k, v, pos_q, pos_k, *, splits, window=None,
                             scale=None):
    """The split route's algorithm: the Sk key slots cut into ``splits``
    contiguous ranges of ceil(Sk / splits) slots (the last ranges may be
    empty), a partial (m, l, acc) per range, m starting at −1e30 as in the
    kernel, then the ranges merged in order: M = max m, out = Σ acc·e^(m−M)
    / max(Σ l·e^(m−M), 1e−30). An empty range has (−1e30, 0, 0) and so
    weighs nothing."""
    s = _masked_scores(q, k, pos_q, pos_k, window, scale)   # (B,KV,G,Sq,Sk)
    vf = v.to(torch.float32)
    Sk = k.shape[1]
    per = -(-Sk // splits)
    parts = []
    for i in range(splits):
        lo, hi = min(Sk, i * per), min(Sk, (i + 1) * per)
        sb = s[..., lo:hi]
        m = torch.full(s.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=s.device)
        if hi > lo:
            m = torch.maximum(m, torch.amax(sb, dim=-1))
        p = torch.exp(sb - m[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgqs,bskd->bkgqd", p, vf[:, lo:hi])))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(top)
    acc = torch.zeros_like(parts[0][2])
    for m, lp, ap in parts:
        w = torch.exp(m - top)
        l = l + lp * w
        acc = acc + ap * w[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)
