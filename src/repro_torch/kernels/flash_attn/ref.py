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

``split_kv_flash_attention`` and ``tensor_core_flash_attention`` are the
split and tensor-core routes' algorithms in the same math, for the CPU
tests of those algorithms; nothing on the main path calls them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# query rows per block of the tensor-core kernel (its skip decisions are
# per block)
TC_BLOCK_ROWS = 128


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


def ref_flash_attention(q, k, v, pos_q, pos_k, *, window=None, scale=None,
                        return_lse=False):
    """With ``return_lse``, also the float32 log-sum-exp (B, KV, G, Sq) of
    each row's scores, m + log(max(l, 1e-30)) as the reference's forward
    saves it for the backward (a row that sees no key: -1e30)."""
    s = _masked_scores(q, k, pos_q, pos_k, window, scale)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p / l,
                       v.to(torch.float32)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


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


def tensor_core_flash_attention(q, k, v, pos_q, pos_k, *, window=None,
                                scale=None, tile=64, skip=True):
    """The tensor-core route's algorithm. Per (batch, kv head) pair, row r
    is (query r // G, group r % G), and the rows go in blocks of
    ``TC_BLOCK_ROWS``. Each block walks the key slots in tiles of ``tile``
    with an online softmax (m from −1e30, slots past Sk at −inf), P
    rounded to bf16 before P·V, l summed from the unrounded P. With
    ``skip`` a block passes over a tile unless some valid key of it may be
    seen by one of its real rows: least valid position <= the block's
    greatest pos_q and, under a window, the block's least pos_q − the
    greatest valid position < window. If a real row of the block then
    ends with m = −1e30 (it saw no key), the block walks every tile again,
    so that row averages V over all Sk slots as the reference does."""
    B, Sq, KV, G, dk = q.shape
    Sk, dv = k.shape[1], v.shape[-1]
    R = Sq * G
    s = _masked_scores(q, k, pos_q, pos_k, window, scale)   # (B,KV,G,Sq,Sk)
    s = s.permute(0, 1, 3, 2, 4).reshape(B, KV, R, Sk)
    nt = -(-Sk // tile)
    pad = nt * tile - Sk
    s = F.pad(s, (0, pad), value=float("-inf"))
    vf = F.pad(v.to(torch.float32), (0, 0, 0, 0, 0, pad))
    pk = pos_k if pos_k.dim() == 2 else pos_k[None, :].expand(B, -1)
    pk = F.pad(pk.to(torch.int64), (0, pad), value=-1).reshape(B, nt, tile)
    big = torch.iinfo(torch.int64).max
    lo = torch.where(pk >= 0, pk, big).amin(-1)          # (B, nt)
    hi = pk.amax(-1)                                     # -1: no valid key
    blk = torch.arange(R) // TC_BLOCK_ROWS               # row -> block
    nb = -(-R // TC_BLOCK_ROWS)

    def per_block(x, fill):
        """(..., R) -> (..., nb, TC_BLOCK_ROWS), padding rows at fill."""
        x = F.pad(x, (0, nb * TC_BLOCK_ROWS - R), value=fill)
        return x.reshape(*x.shape[:-1], nb, TC_BLOCK_ROWS)

    pq = pos_q.to(torch.int64)[torch.arange(R) // G]
    qmin = per_block(pq, big).amin(-1)                   # (nb,)
    qmax = per_block(pq, -big).amax(-1)
    vis = (hi[:, None, :] >= 0) & (lo[:, None, :] <= qmax[None, :, None])
    if window is not None:
        vis &= (qmin[None, :, None] - hi[:, None, :]) < window
    vis = vis[:, blk]                                    # (B, R, nt)

    def walk(visit):
        m = torch.full((B, KV, R), NEG_INF)
        l = torch.zeros((B, KV, R))
        acc = torch.zeros((B, KV, R, dv))
        for t in range(nt):
            st = s[..., t * tile:(t + 1) * tile]
            m_new = torch.maximum(m, st.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(st - m_new[..., None])
            pv = torch.einsum("bkrs,bskd->bkrd",
                              p.to(torch.bfloat16).to(torch.float32),
                              vf[:, t * tile:(t + 1) * tile])
            on = visit[:, None, :, t]                    # (B, 1, R)
            m = torch.where(on, m_new, m)
            l = torch.where(on, l * corr + p.sum(-1), l)
            acc = torch.where(on[..., None], acc * corr[..., None] + pv, acc)
        return m, l, acc

    m, l, acc = walk(vis if skip else torch.ones_like(vis))
    if skip:
        again = per_block(m == NEG_INF, False).any(-1)[:, :, blk]
        if bool(again.any()):
            _, l2, acc2 = walk(torch.ones_like(vis))
            l = torch.where(again, l2, l)
            acc = torch.where(again[..., None], acc2, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, KV, Sq, G, dv).permute(0, 2, 1, 3, 4)
    return out.to(q.dtype)
