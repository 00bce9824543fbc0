"""Feed-forward variants: dense (SwiGLU / GELU / GeGLU) and Mixture-of-Experts.

Port of ``repro.models.ffn``. Dense FFNs route through ``common.linear``,
so the paper's PIM bit-plane quantized path (cfg.quant) applies
transparently. The reference's ``jax.nn.gelu`` defaults to the tanh
approximation, and so does the port.

MoE is the reference's GShard-style capacity dispatch over chunks of
``dispatch_chunk`` tokens, with over-capacity tokens dropped in slot-major
priority, in both of its forms: ``impl="einsum"`` (one-hot dispatch in
bf16, combine in float32) and ``impl="gather"`` (slot tables, a gather and
a combine). The expert products are plain batched matmuls, as in the
reference. Nothing here waits on the host: the capacity and the chunks are
static, one-hots compare against an ``arange`` (no ``num_classes``
inference), and the gather form sums each token's expert outputs in a
fixed order (ascending expert, as the reference's serial scatter-add
does) instead of an atomic ``index_add_``, so a CUDA graph captures it and
its replays are bit-equal to the eager calls.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import (dtype_of, frozen, gather_dims, hold, is_dtensor,
                     linear, make_linear_params, reshape)


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


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

class MoEFFN(nn.Module):
    """A float32 ``router`` (D, E); the stacked experts' ``w1``/``w3``
    (E, D, F) and ``w2`` (E, F, D) in the model's dtype; and a ``shared``
    ``DenseFFN`` of width ``d_ff_expert · n_shared_experts`` (quantized
    when the config is) where the config has shared experts."""

    def __init__(self, router, w1, w3, w2, shared: DenseFFN | None = None):
        super().__init__()
        self.router = frozen(router)
        self.w1, self.w3, self.w2 = frozen(w1), frozen(w3), frozen(w2)
        self.shared = shared


def init_moe(gen, cfg) -> MoEFFN:
    """Random experts drawn one tensor at a time on ``gen``'s device, each
    in float32 and cast to the model's dtype."""
    m = cfg.moe
    D, F_, E = cfg.d_model, m.d_ff_expert, m.n_experts
    dt, dev = dtype_of(cfg), gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * scale).to(dt)

    router = torch.randn((D, E), generator=gen, dtype=torch.float32,
                         device=dev) * (1.0 / math.sqrt(D))
    w1 = normal((E, D, F_), 1.0 / math.sqrt(D))
    w3 = normal((E, D, F_), 1.0 / math.sqrt(D))
    w2 = normal((E, F_, D), 1.0 / math.sqrt(F_))
    shared = (init_dense_ffn(gen, cfg, m.d_ff_expert * m.n_shared_experts)
              if m.n_shared_experts else None)
    return MoEFFN(router, w1, w3, w2, shared)


def _capacity(chunk: int, cfg) -> int:
    m = cfg.moe
    c = int(math.ceil(chunk * m.top_k * m.capacity_factor / m.n_experts))
    return max(4, -(-c // 4) * 4)                      # pad to multiple of 4


def _one_hot(idx, n: int, dtype):
    """(..., n) one-hot of ``idx`` against ``arange(n)``: no host sync."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router(cfg, p: MoEFFN, xc):
    """float32 logits, softmax and top-k: (gates (c, K), experts (c, K),
    the Switch-style load-balance term)."""
    m = cfg.moe
    logits = xc.to(torch.float32) @ p.router                     # (c, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)              # (c, K)
    if m.norm_topk_prob:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    f = _one_hot(idx[:, 0], m.n_experts, torch.float32).mean(0)
    aux = m.n_experts * torch.sum(f * probs.mean(0))
    return gates, idx, aux


def _expert_ffn(p: MoEFFN, xe):
    """xe: (E, C, D) → (E, C, D), stacked-expert SwiGLU. A bf16 ``xe``
    meets float32 experts in float32, as the reference's type promotion
    does."""
    xe = xe.to(torch.promote_types(xe.dtype, p.w1.dtype))
    h = F.silu(torch.bmm(xe, p.w1)) * torch.bmm(xe, p.w3)
    return torch.bmm(h, p.w2)


def _einsum_chunk(cfg, p: MoEFFN, xc, C: int):
    """The reference's ``one_chunk``: per slot in priority order, one-hot
    positions within each expert's capacity; dispatch in bf16, combine in
    float32."""
    gates, idx, aux = _router(cfg, p, xc)
    yc = _einsum_dispatch(cfg, p, xc, gates, idx, C)
    return yc.to(xc.dtype), aux


def _einsum_dispatch(cfg, p, xc, gates, idx, C: int, lo: int = 0):
    """The einsum form's dispatch, experts and combine for the experts
    ``p.w1`` holds, the global experts ``lo`` on (all of them, but on the
    sharded path a device's own): their float32 share of the output."""
    E, K = p.w1.shape[0], cfg.moe.top_k
    c = xc.shape[0]
    counts = torch.zeros((E,), dtype=torch.float32, device=xc.device)
    dispatch = torch.zeros((c, E, C), dtype=torch.bfloat16, device=xc.device)
    combine = torch.zeros((c, E, C), dtype=torch.float32, device=xc.device)
    for slot in range(K):                                        # priority
        e = idx[:, slot] if lo == 0 else idx[:, slot] - lo
        oh = _one_hot(e, E, torch.float32)                       # (c, E)
        pos = torch.cumsum(oh, dim=0) - 1.0 + counts[None, :]
        counts = counts + oh.sum(0)
        keep = (pos < C).to(torch.float32) * oh
        pos_c = torch.clamp(pos, 0, C - 1).to(torch.int32)
        oh_c = _one_hot(pos_c, C, torch.float32) * keep[..., None]
        dispatch = dispatch + oh_c.to(torch.bfloat16)
        combine = combine + oh_c * gates[:, slot, None, None]
    xe = torch.einsum("td,tec->ecd", xc.to(torch.bfloat16), dispatch)
    ye = _expert_ffn(p, xe)                                      # (E, C, D)
    return torch.einsum("ecd,tec->td", ye.to(torch.float32), combine)


def _gather_chunk(cfg, p: MoEFFN, xc, C: int):
    """The reference's ``_gather_chunk``: slot tables (E, C) of token and
    gate, a gather into the experts and a combine; the same capacity drops
    and slot-major priority as the einsum form."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    c, D = xc.shape
    dev = xc.device
    gates, idx, aux = _router(cfg, p, xc)
    # slot-major flattening (all tokens' slot 0 first — GShard priority)
    e_sm = idx.T.reshape(-1)                                     # (Kc,)
    g_sm = gates.T.reshape(-1)
    tok_sm = torch.arange(c, device=dev).repeat(K)
    oh = _one_hot(e_sm, E, torch.int32)                          # (Kc, E)
    pos = (torch.cumsum(oh, dim=0) - 1).gather(1, e_sm[:, None])[:, 0]
    keep = pos < C
    # slot tables (E, C+1), column C the dump of the dropped entries
    flat = e_sm * (C + 1) + torch.where(keep, pos, C)
    slot_tok = torch.full((E * (C + 1),), -1, dtype=torch.long,
                          device=dev).scatter_(0, flat, tok_sm)
    slot_tok = slot_tok.view(E, C + 1)[:, :C]
    slot_gate = torch.zeros((E * (C + 1),), dtype=torch.float32,
                            device=dev).scatter_(0, flat, g_sm)
    slot_gate = slot_gate.view(E, C + 1)[:, :C]
    valid = slot_tok >= 0
    xe = xc[slot_tok.clamp(0, c - 1)] * valid[..., None].to(xc.dtype)
    ye = _expert_ffn(p, xe)                                      # (E, C, D)
    contrib = (ye.to(torch.float32) * slot_gate[..., None]).reshape(E * C, D)
    # each token's kept slots, in ascending expert order, summed in that
    # order; a dropped slot reads the zero row E·C
    table = torch.cat([contrib, contrib.new_zeros((1, D))])
    order = torch.argsort(idx, dim=1)                            # (c, K)
    e_tk = idx.gather(1, order)
    pos_tk = pos.view(K, c).T.gather(1, order)
    keep_tk = keep.view(K, c).T.gather(1, order)
    rows = torch.where(keep_tk, e_tk * C + pos_tk, E * C)
    y = torch.zeros((c, D), dtype=torch.float32, device=dev)
    for j in range(K):
        y = y + table[rows[:, j]]
    return y.to(xc.dtype), aux


def _sharded_moe(cfg, p: MoEFFN, x, chunk: int, C: int):
    """``moe_ffn`` on DTensors: each device runs the chunks of its own
    tokens (the batch's data dims) against its own experts (the experts'
    dim sharded over "model": expert parallelism), the einsum form's
    dispatch restricted to those experts, so that the outputs are partial
    sums over the expert-parallel dims (reduced after); the router and its
    load-balance term run on every device, the term weighted so that it
    sums to the reference's mean over chunks. The gather form gathers the
    experts first (recorded) and runs whole on every device."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    m = cfg.moe
    B, S, D = x.shape
    xf = reshape(x, (B * S, D), "moe/tokens")
    mesh = xf.device_mesh
    dp = math.prod(mesh.size(i) for i, pl in enumerate(xf.placements)
                   if pl == Shard(0))
    if (xf.shape[0] // dp) % chunk:
        # a chunk spans devices (decode's few tokens): every device takes
        # all of them
        xf = gather_dims(xf, (0,), "moe/tokens", "gather")
    ws = [p.w1, p.w3, p.w2]
    if m.impl == "gather":
        ws = [gather_dims(w, (0,), "moe/experts", "gather") for w in ws]
    tok = [pl == Shard(0) for pl in xf.placements]
    ep = [pl == Shard(0) for pl in ws[0].placements]
    if any(pl.is_shard() and pl.dim != 0 for pl in xf.placements) or any(
            t and e for t, e in zip(tok, ep)):
        raise ValueError(f"moe_ffn: tokens {xf.placements}, experts "
                         f"{ws[0].placements}")
    n_local = xf.shape[0] // math.prod(
        mesh.size(i) for i, t in enumerate(tok) if t)
    if n_local % chunk:
        raise ValueError(f"moe_ffn: {n_local} tokens per device are not a "
                         f"multiple of the dispatch chunk {chunk}")
    E_l = ws[0].shape[0] // math.prod(
        mesh.size(i) for i, e in enumerate(ep) if e)
    lo = 0
    for i, e in enumerate(ep):
        if e:
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    lo *= E_l
    split = math.prod(mesh.size(i) for i in range(mesh.ndim)
                      if tok[i] or ep[i])
    R = Replicate()
    y_pl = tuple(Shard(0) if t else Partial() if e else R
                 for t, e in zip(tok, ep))
    x_grad = tuple(Shard(0) if t else Partial() if e else R
                   for t, e in zip(tok, ep))
    sum_pl = tuple(Partial() if t or e else R for t, e in zip(tok, ep))
    w_grad = tuple(Shard(0) if e else Partial() if t else R
                   for t, e in zip(tok, ep))

    def local(xl, router, w1, w3, w2):
        q = SimpleNamespace(router=router, w1=w1, w3=w3, w2=w2)

        def one_chunk(xc):
            if m.impl == "gather":
                y, aux = _gather_chunk(cfg, q, xc, C)
                return y.to(torch.float32), aux
            gates, idx, aux = _router(cfg, q, xc)
            return _einsum_dispatch(cfg, q, xc, gates, idx, C, lo), aux

        # the chunks side by side (the reference's scan body once)
        ys, auxs = torch.vmap(one_chunk)(xl.reshape(-1, chunk, D))
        return ys.reshape(-1, D), auxs.mean() / split

    y, aux = local_map(
        local, out_placements=(y_pl, sum_pl),
        in_placements=(xf.placements, p.router.placements)
        + tuple(w.placements for w in ws),
        in_grad_placements=(x_grad, sum_pl) + (w_grad,) * 3,
        device_mesh=mesh)(xf, p.router, *ws)
    y = reshape(hold(y, "moe out").to(x.dtype), (B, S, D), "moe/tokens")
    if m.n_shared_experts:
        y = y + dense_ffn(cfg, p.shared, x)
    return y, m.router_aux_weight * aux


def moe_ffn(cfg, p: MoEFFN, x):
    """x: (B, S, D) → (y, aux_loss)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    chunk = min(m.dispatch_chunk, T)
    if is_dtensor(x):
        return _sharded_moe(cfg, p, x, chunk, _capacity(chunk, cfg))
    xf = x.reshape(T, D)
    if T % chunk:
        raise ValueError(f"moe_ffn: {T} tokens are not a multiple of the "
                         f"dispatch chunk {chunk}")
    if m.impl not in ("einsum", "gather"):
        raise ValueError(f"moe_ffn: unknown impl {m.impl!r}")
    C = _capacity(chunk, cfg)
    body = _gather_chunk if m.impl == "gather" else _einsum_chunk
    ys, auxs = [], []
    for i in range(0, T, chunk):
        y, aux = body(cfg, p, xf[i:i + chunk], C)
        ys.append(y)
        auxs.append(aux)
    y = torch.cat(ys).reshape(B, S, D)
    if m.n_shared_experts:
        y = y + dense_ffn(cfg, p.shared, x)
    return y, m.router_aux_weight * torch.stack(auxs).mean()
