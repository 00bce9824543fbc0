"""Mamba-1 selective SSM block (falcon-mamba-7b family).

Port of ``repro.models.ssm``. Prefill runs the reference's chunked scan:
the sequence is cut into chunks of ``ssm.scan_chunk`` steps (the last one
padded with identity steps, dt = 0, so that the final state is exact), and
the (B, chunk, d_inner, d_state) float32 decays and inputs of a chunk are
built at once. Where the reference runs an associative scan inside the
chunk, the port runs ``scan_inplace``: a loop over the chunk's steps, one
``addcmul`` each, which a CUDA graph captures (static shapes, no host
synchronisation). The float32 sums then go in sequence order, the
reference's in its scan tree's order.

Decode is the O(1)-state recurrence on ``{"h": (B, I, N) float32, "conv":
(B, d_conv - 1, I)}``, which ``mamba_decode`` updates in place.

The reference's float32 islands stay float32: ``dt_r @ dt_proj`` and the
softplus with ``dt_bias``, the decays from ``A_log``, the state, ``D`` and
the decode conv.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init, dtype_of, frozen, pad, rmsnorm


class Mamba(nn.Module):
    """``in_proj`` (D, 2I), ``conv_w`` (d_conv, I), ``conv_b`` (I,),
    ``x_proj`` (I, dt_rank + 2N), ``dt_proj`` (dt_rank, I), float32
    ``dt_bias`` (I,), ``A_log`` (I, N) and ``D`` (I,), ``out_proj`` (I, D);
    with ``extra_norms``, the RMSNorm weights ``dt_norm``, ``b_norm`` and
    ``c_norm``."""

    def __init__(self, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias,
                 A_log, D, out_proj, *, dt_norm=None, b_norm=None,
                 c_norm=None):
        super().__init__()
        self.in_proj, self.conv_w, self.conv_b = map(
            frozen, (in_proj, conv_w, conv_b))
        self.x_proj, self.dt_proj = frozen(x_proj), frozen(dt_proj)
        self.dt_bias, self.A_log, self.D = map(frozen, (dt_bias, A_log, D))
        self.out_proj = frozen(out_proj)
        self.dt_norm, self.b_norm, self.c_norm = map(
            frozen, (dt_norm, b_norm, c_norm))


def init_mamba(gen: torch.Generator, cfg) -> Mamba:
    s = cfg.ssm
    D = cfg.d_model
    I = s.expand * D
    dt, dev = dtype_of(cfg), gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    norms = {}
    if s.extra_norms:
        norms = dict(dt_norm=torch.ones((s.dt_rank,), dtype=dt, device=dev),
                     b_norm=torch.ones((s.d_state,), dtype=dt, device=dev),
                     c_norm=torch.ones((s.d_state,), dtype=dt, device=dev))
    return Mamba(
        in_proj=dense_init(gen, D, 2 * I, dt),
        conv_w=(torch.randn((s.d_conv, I), generator=gen, **f32)
                * 0.1).to(dt),
        conv_b=torch.zeros((I,), dtype=dt, device=dev),
        x_proj=dense_init(gen, I, s.dt_rank + 2 * s.d_state, dt),
        dt_proj=dense_init(gen, s.dt_rank, I, dt),
        dt_bias=torch.full((I,), -4.6, **f32),          # softplus ≈ 0.01
        A_log=torch.log(torch.arange(1, s.d_state + 1, **f32)).repeat(I, 1),
        D=torch.ones((I,), **f32),
        out_proj=dense_init(gen, I, D, dt),
        **norms)


def conv_causal(conv_w, conv_b, x, d_conv: int):
    """Causal depthwise conv over (B, S, C) in x's dtype: the taps added
    in order, then the bias, as the reference's ``sum`` does."""
    S = x.shape[1]
    xp = pad(x, (0, 0, d_conv - 1, 0))
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(d_conv))
    return out + conv_b


def conv_window(conv_w, conv_b, state_conv, x_new, d_conv: int):
    """Decode's conv: the window (B, d_conv, C) of the state's last
    ``d_conv - 1`` inputs and the new one (B, 1, C), and its float32 conv
    (B, C). A prompt shorter than ``d_conv - 1`` leaves a shorter state,
    with which the reference's decode fails; so does this one."""
    if state_conv.shape[1] != d_conv - 1:
        raise ValueError(
            f"the conv state holds {state_conv.shape[1]} inputs, d_conv - 1 "
            f"= {d_conv - 1} needed: a prompt shorter than d_conv - 1 leaves "
            "a short state, and decode cannot follow it (as in the "
            "reference)")
    window = torch.cat([state_conv, x_new], dim=1)
    conv = torch.einsum("bci,ci->bi", window.to(torch.float32),
                        conv_w.to(torch.float32)) + conv_b.to(torch.float32)
    return window, conv


def records_grad(*tensors) -> bool:
    """True when autograd records an op on any of ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def scan_inplace(a, b, h0):
    """h_t = a_t · h_{t-1} + b_t over dim 1 of (B, c, ...) float32, from
    h0 (B, ...), one ``addcmul`` per step. Serving writes each h_t over
    b_t and returns b, now the states; when autograd records (training),
    which refuses writes into saved tensors, the same adds in the same
    order go to new tensors, stacked into the states returned."""
    h = h0
    if records_grad(a, b, h0):
        hs = []
        for t in range(b.shape[1]):
            h = torch.addcmul(b[:, t], a[:, t], h)
            hs.append(h)
        return torch.stack(hs, dim=1)
    for t in range(b.shape[1]):
        h = torch.addcmul(b[:, t], a[:, t], h, out=b[:, t])
    return b


def chunks(S: int, scan_chunk: int) -> tuple[int, int]:
    """(chunk, padded length): the reference's ``min(scan_chunk, S)`` and
    S rounded up to a multiple of it."""
    chunk = min(scan_chunk, S)
    return chunk, -(-S // chunk) * chunk


def _split_dbc(s, p: Mamba, dbc):
    dt_r, Bm, Cm = torch.split(dbc, [s.dt_rank, s.d_state, s.d_state],
                               dim=-1)
    if s.extra_norms:
        dt_r = rmsnorm(dt_r, p.dt_norm)
        Bm = rmsnorm(Bm, p.b_norm)
        Cm = rmsnorm(Cm, p.c_norm)
    dt = F.softplus(dt_r.to(torch.float32) @ p.dt_proj.to(torch.float32)
                    + p.dt_bias)
    return dt, Bm.to(torch.float32), Cm.to(torch.float32)


def mamba_train(cfg, p: Mamba, x):
    """x: (B, S, D) → (y (B, S, D), {"h": (B, I, N) float32, "conv": the
    last d_conv - 1 inputs of the conv (B, ·, I)}). Chunked selective
    scan."""
    s = cfg.ssm
    B, S, _ = x.shape
    u_pre, z = torch.chunk(x @ p.in_proj, 2, dim=-1)
    u = F.silu(conv_causal(p.conv_w, p.conv_b, u_pre, s.d_conv))
    dt, Bm, Cm = _split_dbc(s, p, u @ p.x_proj)
    A = -torch.exp(p.A_log)                                     # (I, N)
    uf = u.to(torch.float32)

    chunk, Sp = chunks(S, s.scan_chunk)
    # identity steps past the end (dt = 0: a = 1, b = 0) keep the final
    # state exact; their outputs are sliced off below
    dt, Bm, Cm, uf_s = (pad(t, (0, 0, 0, Sp - S))
                        for t in (dt, Bm, Cm, uf))
    h = torch.zeros((B, A.shape[0], A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, Sp, chunk):
        dt_c, b_c = dt[:, c0:c0 + chunk], Bm[:, c0:c0 + chunk]
        a = torch.exp_(dt_c[..., None] * A)                     # (B,c,I,N)
        bx = (dt_c * uf_s[:, c0:c0 + chunk])[..., None] * b_c[:, :, None, :]
        hs = scan_inplace(a, bx, h)
        ys.append(torch.einsum("bcin,bcn->bci", hs, Cm[:, c0:c0 + chunk]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :S] + uf * p.D
    y = y.to(x.dtype) * F.silu(z)
    state = {"h": h.clone(), "conv": u_pre[:, S - (s.d_conv - 1):]}
    return y @ p.out_proj, state


def mamba_decode(cfg, p: Mamba, x, state):
    """x: (B, 1, D); state: {"h": (B, I, N) float32, "conv": (B, d_conv - 1,
    I)}, updated in place and returned beside the output (B, 1, D)."""
    s = cfg.ssm
    u_pre, z = torch.chunk(x @ p.in_proj, 2, dim=-1)            # (B,1,I)
    window, conv = conv_window(p.conv_w, p.conv_b, state["conv"], u_pre,
                               s.d_conv)
    u = F.silu(conv)[:, None, :].to(x.dtype)                    # (B,1,I)
    dt, Bm, Cm = _split_dbc(s, p, u @ p.x_proj)
    A = -torch.exp(p.A_log)
    a = torch.exp(dt[:, 0, :, None] * A)                        # (B,I,N)
    uf = u[:, 0].to(torch.float32)
    bx = (dt[:, 0] * uf)[..., None] * Bm[:, 0][:, None, :]
    h = a * state["h"] + bx
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0]) + uf * p.D
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return y @ p.out_proj, state


def mamba_init_state(cfg, batch: int, device):
    s = cfg.ssm
    I = s.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, I, s.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, I), dtype=dtype_of(cfg),
                            device=device),
    }
