"""Plain torch version of the flash-attention forward: masked softmax.

It is the plain version of the CUDA kernel in ``csrc/flash_attn.cu``: the
CPU runs it, and ``chip_smoke.py`` holds the kernel against it on the card.
It computes the reference's ``ref_flash_attention`` on the models' layout,
with a batch axis and per-row key positions:

  q (B, Sq, KV, G, dh) — query heads grouped by kv head (head h = kv·G + g
  reads kv head h // G); k/v (B, Sk, KV, dh); pos_q (Sq,); pos_k (B, Sk)
  or (Sk,), −1 marking an invalid key. A key is seen iff
  0 ≤ pos_k ≤ pos_q (and pos_q − pos_k < window). Returns q's shape and
  dtype; the scores and the softmax are float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_flash_attention(q, k, v, pos_q, pos_k, *, window=None, scale=None):
    B, Sq, KV, G, dh = q.shape
    scale = (dh ** -0.5) if scale is None else scale
    pk = pos_k if pos_k.dim() == 2 else pos_k[None, :].expand(B, -1)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    pq = pos_q[None, None, None, :, None]
    pkb = pk[:, None, None, None, :]
    ok = (pkb >= 0) & (pkb <= pq)
    if window is not None:
        ok &= (pq - pkb) < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.to(q.dtype)
