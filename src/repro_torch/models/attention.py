"""Attention: GQA/MQA (+RoPE, qk-norm, bias, sliding window) and
DeepSeek-V2 MLA (with the absorbed-projection decode path).

Port of ``repro.models.attention``. Every softmax goes through
``chunked_attention``:

- ``impl="flash"`` runs the flash-attention forward of
  ``kernels/flash_attn`` (the CUDA kernel for a CUDA tensor, its plain
  version on the CPU) — the port's counterpart of the reference's
  ``models/flash.py`` forward, which has the same masking semantics; when
  autograd records (training) it goes through ``models.flash``'s
  ``FlashAttention``, that forward with its log-sum-exp and the
  reference's backward;
- ``impl="naive"`` is a torch port of the reference's online-softmax scan
  over query and key chunks.

On the sharded path (DTensor parameters, ``launch.sharding``) the
reference's ``sp_attn`` sharding constraints apply (``common.constrain``;
no-ops on plain tensors), and a head split that DTensor cannot carry over
an unevenly sharded projection gathers it first (``common.reshape``).
Decode caches are updated in place: ``gqa_decode`` and ``mla_decode``
write the new token's entries into the cache they are given and return
that cache.

MLA's prefill materializes per-head keys (192 = nope 128 + rope 64) and
values (128), one kv head per query head; its decode absorbs W_uk into the
query and scores against the cached [latent ⊕ rope] stream (576 wide, one
kv head for all 16 query heads, values the 512-wide latent). On the card
the first takes the flash kernel's tensor-core route, the second its
split-over-keys route.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.flash_attn import ops as _flash
from . import flash as flash_mod
from .flash import _chunk
from .common import (apply_rope, constrain, dense_init, dtype_of, frozen,
                     gather_dims, is_dtensor, redistribute, reshape,
                     rmsnorm)
from .ssm import records_grad

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked attention
# ---------------------------------------------------------------------------

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
    if is_dtensor(q):
        return _sharded_attention(q, k, v, pos_q, pos_k, window=window,
                                  scale=scale, impl=impl)
    if impl == "flash":
        if records_grad(q, k, v):
            return flash_mod.flash_attention(q, k, v, pos_q, pos_k,
                                             window=window, scale=scale,
                                             q_chunk=q_chunk, k_chunk=k_chunk)
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


def _sharded_attention(q, k, v, pos_q, pos_k, *, window, scale, impl):
    """Attention on DTensors: each device attends over its own shards, the
    batch over the mesh dims that shard it in q, k and v alike, the kv
    heads likewise (no communication, as XLA partitions attention); a mesh
    dim that shards anything else (a sequence, a head's width, q and k
    apart) is gathered first and recorded. Locally it is this module's
    ``chunked_attention`` in one tile (``local_map``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    target = []
    for i in range(mesh.ndim):
        ps = {t.placements[i] for t in (q, k, v)}
        target.append(ps.pop() if len(ps) == 1 and ps <= {Shard(0), Shard(2)}
                      else Replicate())
    q, k, v = (redistribute(t, target, f"attn/{n}", "gather")
               for t, n in ((q, "q"), (k, "k"), (v, "v")))

    def rep(t, batch_dim):
        pl = [p if batch_dim and p == Shard(0) else Replicate()
              for p in target]
        if not is_dtensor(t):
            return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False).redistribute(mesh, pl)
        return redistribute(t, pl, "attn/positions", "gather")

    pos_q, pos_k = rep(pos_q, False), rep(pos_k, pos_k.dim() == 2)
    Sq, Sk = q.shape[1], k.shape[1]

    def local(ql, kl, vl, pq, pk):
        return chunked_attention(ql, kl, vl, pq, pk, window=window,
                                 q_chunk=Sq, k_chunk=Sk, scale=scale,
                                 impl=impl)

    return local_map(local, out_placements=(tuple(target),),
                     in_placements=(tuple(target),) * 3
                     + (pos_q.placements, pos_k.placements),
                     device_mesh=mesh)(q, k, v, pos_q, pos_k)


def _write_slot(cache: dict, slot: int, entries: dict, pos: int) -> None:
    """Write one token's entries (each (B, ...)) and its position at
    ``slot`` of a cache's (B, Sc, ...) tensors, in place. A DTensor cache
    (its slots sharded) takes an elementwise select against the slot, which
    keeps its sharding; a plain one an indexed write."""
    if not is_dtensor(cache["kpos"]):
        for name, e in entries.items():
            cache[name][:, slot] = e
        cache["kpos"][:, slot] = pos
        return
    Sc = cache["kpos"].shape[1]
    hit = torch.arange(Sc, device=entries[next(iter(entries))].device) == slot
    for name, e in entries.items():
        t = cache[name]
        h = hit.reshape((1, Sc) + (1,) * (t.dim() - 2))
        t.copy_(torch.where(h, e[:, None].to(t.dtype), t))
    kp = cache["kpos"]
    kp.copy_(torch.where(hit[None, :], torch.full((), pos, dtype=kp.dtype),
                         kp))


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
    q = reshape(_proj(x, p.wq, p.bq), (B, S, H, dh), "attn/q heads")
    k = reshape(_proj(x, p.wk, p.bk), (B, S, KV, dh), "attn/k heads")
    v = reshape(_proj(x, p.wv, p.bv), (B, S, KV, dh), "attn/v heads")
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _split_kv_heads(q, k, v, H: int, KV: int):
    """(k, v, kv heads) for attention. On the sharded path, where the query
    heads split evenly over the mesh dims that shard them and the kv heads
    do not, each kv head is repeated ``r`` times, the least ``r`` whose
    ``KV·r`` heads split evenly and still group the query heads, and the
    copies take the query heads' sharding: every device then attends with
    its own query heads against its own copy of their kv head, where XLA
    pads the heads and gathering them would replicate attention. The
    gather and the repeat are recorded. Plain tensors, and heads that
    split evenly, are returned as they are."""
    if not is_dtensor(q):
        return k, v, KV
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    ways = math.prod(mesh.size(i) for i, pl in enumerate(q.placements)
                     if pl == Shard(2))
    if ways == 1 or KV % ways == 0 or H % ways:
        return k, v, KV
    r = next((r for r in range(2, ways + 1)
              if (KV * r) % ways == 0 and H % (KV * r) == 0), None)
    if r is None:
        return k, v, KV
    B, S, _, dh = k.shape

    def repeat(t, name):
        t = gather_dims(t, (2, 3), f"attn/{name} repeat", "gather")
        t = reshape(t[:, :, :, None].expand(B, S, KV, r, dh),
                    (B, S, KV * r, dh), f"attn/{name} repeat")
        return redistribute(t, [Shard(2) if q.placements[i] == Shard(2)
                                else pl for i, pl in enumerate(t.placements)],
                            f"attn/{name} repeat", "shard")

    return repeat(k, "k"), repeat(v, "v"), KV * r


def gqa_train(cfg, p: GQA, x, positions, window=None):
    """Full causal attention; returns (out, (k, v) for cache building)."""
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    if cfg.sp_attn and S > 1:
        # Sequence-parallel attention: queries sharded on S over "model",
        # (small GQA) k/v gathered — avoids per-layer head resharding when
        # n_heads is not divisible by the model axis.
        q = constrain(q, (None, "model", None, None))
        k = constrain(k, (None, None, None, None))
        v = constrain(v, (None, None, None, None))
    kv = (k, v)
    k, v, KV = _split_kv_heads(q, k, v, H, KV)
    qg = reshape(q, (B, S, KV, H // KV, dh), "attn/q groups")
    out = chunked_attention(qg, k, v, positions, positions, window=window,
                            q_chunk=cfg.attn_q_chunk,
                            k_chunk=cfg.attn_k_chunk, impl=cfg.attn_impl)
    out = reshape(out, (B, S, H * dh), "attn/out heads")
    if cfg.sp_attn and S > 1:
        out = constrain(out, (None, "model", None))
    return out @ p.wo, kv


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
    _write_slot(cache, pos % cache["k"].shape[1],
                {"k": k[:, 0], "v": v[:, 0]}, pos)
    qg = reshape(q, (B, 1, KV, H // KV, dh), "attn/q groups")
    out = chunked_attention(qg, cache["k"], cache["v"], positions,
                            cache["kpos"], window=window, q_chunk=1,
                            k_chunk=cfg.attn_k_chunk, impl=cfg.attn_impl)
    out = reshape(out, (B, 1, H * dh), "attn/out heads")
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """``w_dkv`` (D, rank + rope), ``kv_norm`` (rank,), ``w_uk`` (rank, H,
    nope), ``w_uv`` (rank, H, v), ``w_q`` (D, H·(nope + rope)), ``w_o``
    (H·v, D)."""

    def __init__(self, w_dkv, kv_norm, w_uk, w_uv, w_q, w_o):
        super().__init__()
        self.w_dkv, self.kv_norm = frozen(w_dkv), frozen(kv_norm)
        self.w_uk, self.w_uv = frozen(w_uk), frozen(w_uv)
        self.w_q, self.w_o = frozen(w_q), frozen(w_o)


def init_mla(gen: torch.Generator, cfg) -> MLA:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    r, nope, rope, vd = (m.kv_lora_rank, m.qk_nope_head_dim,
                         m.qk_rope_head_dim, m.v_head_dim)
    dt = dtype_of(cfg)
    return MLA(w_dkv=dense_init(gen, D, r + rope, dt),
               kv_norm=torch.ones((r,), dtype=dt, device=gen.device),
               w_uk=dense_init(gen, r, H * nope, dt).reshape(r, H, nope),
               w_uv=dense_init(gen, r, H * vd, dt).reshape(r, H, vd),
               w_q=dense_init(gen, D, H * (nope + rope), dt),
               w_o=dense_init(gen, H * vd, D, dt))


def _mla_q(cfg, p: MLA, x, positions):
    m = cfg.mla
    B, S, _ = x.shape
    q = reshape(x @ p.w_q, (B, S, cfg.n_heads,
                            m.qk_nope_head_dim + m.qk_rope_head_dim),
                "attn/q heads")
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(cfg, p: MLA, x, positions):
    m = cfg.mla
    c_kv, k_rope = torch.split(x @ p.w_dkv,
                               [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(c_kv, p.kv_norm)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_scale(m) -> float:
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_train(cfg, p: MLA, x, positions):
    """Non-absorbed path: per-head keys and values, one softmax over the
    nope ⊕ rope features. Returns (out, (c_kv, k_rope) for the cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    H, r = cfg.n_heads, m.kv_lora_rank
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_ckv(cfg, p, x, positions)
    k_nope = reshape(c_kv @ reshape(p.w_uk, (r, -1), "attn/w_uk"),
                     (B, S, H, -1), "attn/k heads")
    v = reshape(c_kv @ reshape(p.w_uv, (r, -1), "attn/w_uv"),
                (B, S, H, m.v_head_dim), "attn/v heads")
    qc = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]  # (B,S,H,1,.)
    kc = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    out = chunked_attention(qc, kc, v, positions, positions,
                            scale=_mla_scale(m), q_chunk=cfg.attn_q_chunk,
                            k_chunk=cfg.attn_k_chunk, impl=cfg.attn_impl)
    out = reshape(out, (B, S, H * m.v_head_dim), "attn/out heads")
    return out @ p.w_o, (c_kv, k_rope)


def mla_decode(cfg, p: MLA, x, pos: int, cache):
    """Absorbed path at absolute position ``pos``: W_uk folded into the
    query, which scores against the cached [latent ⊕ rope] stream; the
    latent context is lifted by W_uv. cache: {ckv: (B, Sc, rank), krope:
    (B, Sc, rope), kpos: (B, Sc)}, written in place at slot ``pos`` (the
    last slot past the end, as the reference's ``dynamic_update_slice``
    clamps) and returned."""
    m = cfg.mla
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"mla_decode takes one token, got {S}")
    H, r = cfg.n_heads, m.kv_lora_rank
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_ckv(cfg, p, x, positions)
    ck, cr, kpos = cache["ckv"], cache["krope"], cache["kpos"]
    _write_slot(cache, min(max(pos, 0), ck.shape[1] - 1),
                {"ckv": c_kv[:, 0], "krope": k_rope[:, 0]}, pos)
    q_abs = torch.einsum("bthd,rhd->bthr", q_nope, p.w_uk)
    qc = torch.cat([q_abs, q_rope], dim=-1)[:, :, None, :, :]   # (B,1,1,H,.)
    kc = torch.cat([ck, cr], dim=-1)[:, :, None, :]             # (B,Sc,1,.)
    ctx = chunked_attention(qc, kc, ck[:, :, None, :], positions, kpos,
                            q_chunk=1, k_chunk=cfg.attn_k_chunk,
                            scale=_mla_scale(m), impl=cfg.attn_impl)
    v_ctx = torch.einsum("bthr,rhd->bthd",
                         reshape(ctx, (B, 1, H, r), "attn/ctx heads"), p.w_uv)
    out = reshape(v_ctx, (B, 1, H * m.v_head_dim), "attn/out heads")
    return out @ p.w_o, cache


def mla_init_cache(cfg, batch: int, max_len: int, device):
    m = cfg.mla
    dt = dtype_of(cfg)
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt,
                           device=device),
        "krope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dt,
                             device=device),
        "kpos": torch.full((batch, max_len), -1, dtype=torch.int32,
                           device=device),
    }
