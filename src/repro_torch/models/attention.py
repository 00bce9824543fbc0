"""Attention: GQA/MQA (+RoPE, qk-norm, bias, sliding window).

Port of the GQA part of ``repro.models.attention``; MLA waits (ROADMAP
A10). Every softmax goes through ``chunked_attention``:

- ``impl="flash"`` runs the flash-attention forward of
  ``kernels/flash_attn`` (the CUDA kernel for a CUDA tensor, its plain
  version on the CPU) — the port's counterpart of the reference's
  ``models/flash.py`` forward, which has the same masking semantics;
- ``impl="naive"`` is a torch port of the reference's online-softmax scan
  over query and key chunks.

The reference's ``sp_attn`` sharding constraints are no-ops on one card.
Decode caches are updated in place: ``gqa_decode`` writes the new key and
value into the cache it is given and returns that cache.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.flash_attn import ops as _flash
from .common import apply_rope, dense_init, dtype_of, frozen, rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked attention
# ---------------------------------------------------------------------------

def _chunk(n: int, c: int) -> int:
    c = min(c, n)
    while n % c:
        c //= 2
    return c


def chunked_attention(q, k, v, pos_q, pos_k, *, window=None,
                      q_chunk: int = 512, k_chunk: int = 1024,
                      scale: float | None = None, impl: str = "flash"):
    """Online-softmax attention.

    q: (B, Sq, KV, G, dh) — query heads grouped by kv head
    k: (B, Sk, KV, dh)
    v: (B, Sk, KV, dv)
    pos_q: (Sq,) int32; pos_k: (Sk,) or (B, Sk) int32 (−1 = invalid slot)
    Causal: attend iff 0 <= pos_k <= pos_q (and pos_q − pos_k < window).
    Returns (B, Sq, KV, G, dv).
    """
    B, Sq, KV, G, dh = q.shape
    scale = (1.0 / math.sqrt(dh)) if scale is None else scale
    if impl == "flash":
        return _flash.flash_attention(q, k, v, pos_q, pos_k, window=window,
                                      scale=scale)
    if impl != "naive":
        raise ValueError(f"unknown attention impl {impl!r}")
    Sk, dv = k.shape[1], v.shape[-1]
    qc, kc = _chunk(Sq, q_chunk), _chunk(Sk, k_chunk)
    pk = (pos_k if pos_k.dim() == 2 else pos_k[None, :]).to(torch.int32)
    pq = pos_q.to(torch.int32)
    outs = []
    for i in range(0, Sq, qc):
        qb = q[:, i:i + qc].to(torch.float32)
        pqb = pq[i:i + qc][None, None, None, :, None]
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, qc, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(0, Sk, kc):
            kb = k[:, j:j + kc].to(torch.float32)
            vb = v[:, j:j + kc].to(torch.float32)
            pkb = pk[:, j:j + kc][:, None, None, None, :]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            ok = (pkb >= 0) & (pkb <= pqb)
            if window is not None:
                ok &= (pqb - pkb) < window
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, vb)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)     # (B,KV,G,qc,dv)
        outs.append(out.permute(0, 3, 1, 2, 4))              # (B,qc,KV,G,dv)
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA / MQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Projections ``wq`` (D, H·dh), ``wk``/``wv`` (D, KV·dh), ``wo``
    (H·dh, D); biases ``bq``/``bk``/``bv`` and qk-norm weights ``q_norm``/
    ``k_norm`` where the config has them."""

    def __init__(self, wq, wk, wv, wo, *, bq=None, bk=None, bv=None,
                 q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(frozen, (wq, wk, wv, wo))
        self.bq, self.bk, self.bv = map(frozen, (bq, bk, bv))
        self.q_norm, self.k_norm = frozen(q_norm), frozen(k_norm)


def init_gqa(gen: torch.Generator, cfg) -> GQA:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt, dev = dtype_of(cfg), gen.device
    extra = {}
    w = dict(wq=dense_init(gen, D, H * dh, dt),
             wk=dense_init(gen, D, KV * dh, dt),
             wv=dense_init(gen, D, KV * dh, dt),
             wo=dense_init(gen, H * dh, D, dt))
    if cfg.qkv_bias:
        extra.update(bq=torch.zeros((H * dh,), dtype=dt, device=dev),
                     bk=torch.zeros((KV * dh,), dtype=dt, device=dev),
                     bv=torch.zeros((KV * dh,), dtype=dt, device=dev))
    if cfg.qk_norm:
        extra.update(q_norm=torch.ones((dh,), dtype=dt, device=dev),
                     k_norm=torch.ones((dh,), dtype=dt, device=dev))
    return GQA(**w, **extra)


def _proj(x, w, b):
    y = x @ w
    return y if b is None else y + b


def _gqa_qkv(cfg, p: GQA, x, positions):
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _proj(x, p.wq, p.bq).reshape(B, S, H, dh)
    k = _proj(x, p.wk, p.bk).reshape(B, S, KV, dh)
    v = _proj(x, p.wv, p.bv).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_train(cfg, p: GQA, x, positions, window=None):
    """Full causal attention; returns (out, (k, v) for cache building)."""
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    qg = q.reshape(B, S, KV, H // KV, dh)
    out = chunked_attention(qg, k, v, positions, positions, window=window,
                            q_chunk=cfg.attn_q_chunk,
                            k_chunk=cfg.attn_k_chunk, impl=cfg.attn_impl)
    out = out.reshape(B, S, H * dh)
    return out @ p.wo, (k, v)


def gqa_decode(cfg, p: GQA, x, pos: int, cache, window=None):
    """One-token decode at absolute position ``pos``.
    cache: {k: (B, Sc, KV, dh), v: ..., kpos: (B, Sc)}, written in place at
    slot ``pos % Sc`` (a ring for sliding windows, the identity for full
    attention) and returned."""
    B, S, D = x.shape
    if S != 1:
        raise ValueError(f"gqa_decode takes one token, got {S}")
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["kpos"][:, slot] = pos
    qg = q.reshape(B, 1, KV, H // KV, dh)
    out = chunked_attention(qg, cache["k"], cache["v"], positions,
                            cache["kpos"], window=window, q_chunk=1,
                            k_chunk=cfg.attn_k_chunk, impl=cfg.attn_impl)
    out = out.reshape(B, 1, H * dh)
    return out @ p.wo, cache


def gqa_init_cache(cfg, batch: int, max_len: int, device):
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    cache_len = min(max_len, cfg.sliding_window or max_len)
    dt = dtype_of(cfg)
    return {
        "k": torch.zeros((batch, cache_len, KV, dh), dtype=dt, device=device),
        "v": torch.zeros((batch, cache_len, KV, dh), dtype=dt, device=device),
        "kpos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                           device=device),
    }
