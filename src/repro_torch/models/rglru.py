"""RG-LRU recurrent block (RecurrentGemma / Griffin family).

    r_t = sigmoid(x_t @ W_a + b_a)            (recurrence gate)
    i_t = sigmoid(x_t @ W_x + b_x)            (input gate)
    a_t = exp(c * log(sigmoid(Λ)) * r_t)      (data-dependent decay)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Port of ``repro.models.rglru``: the Griffin temporal block (value branch →
conv1d → RG-LRU; gate branch → GeLU, the tanh form as ``jax.nn.gelu``'s
default; multiplicative merge, out-projection). Prefill runs the same
chunked scan as ``ssm.py`` (identity padding a = 1, b = 0; a loop over
each chunk's steps), on the element-wise (B, W) state. The gates are
float32 products, as in the reference. Decode carries {"h": (B, W) float32,
"conv": (B, d_conv - 1, W)}, which ``rglru_decode`` updates in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init, dtype_of, elementwise, frozen, pad
from .ssm import (chunks, conv_causal, conv_window, records_grad,
                  scan_inplace)


class RGLRU(nn.Module):
    """``w_in`` and ``w_gate_branch`` (D, W), ``conv_w`` (d_conv, W),
    ``conv_b`` (W,), ``w_a`` and ``w_x`` (W, W) with float32 biases ``b_a``
    and ``b_x``, float32 ``lam`` (W,), ``w_out`` (W, D)."""

    def __init__(self, w_in, w_gate_branch, conv_w, conv_b, w_a, b_a, w_x,
                 b_x, lam, w_out):
        super().__init__()
        self.w_in, self.w_gate_branch = frozen(w_in), frozen(w_gate_branch)
        self.conv_w, self.conv_b = frozen(conv_w), frozen(conv_b)
        self.w_a, self.b_a, self.w_x, self.b_x = map(frozen,
                                                     (w_a, b_a, w_x, b_x))
        self.lam, self.w_out = frozen(lam), frozen(w_out)


def init_rglru(gen: torch.Generator, cfg) -> RGLRU:
    r = cfg.rglru
    D, W = cfg.d_model, r.lru_width
    dt, dev = dtype_of(cfg), gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return RGLRU(
        w_in=dense_init(gen, D, W, dt),
        w_gate_branch=dense_init(gen, D, W, dt),
        conv_w=(torch.randn((r.d_conv, W), generator=gen, **f32)
                * 0.1).to(dt),
        conv_b=torch.zeros((W,), dtype=dt, device=dev),
        w_a=dense_init(gen, W, W, dt),
        b_a=torch.zeros((W,), **f32),
        w_x=dense_init(gen, W, W, dt),
        b_x=torch.zeros((W,), **f32),
        # Λ so that a ≈ 0.9..0.999 at r = 1 (the usual LRU range)
        lam=torch.linspace(2.0, 6.0, W, **f32),
        w_out=dense_init(gen, W, D, dt))


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gates(cfg, p: RGLRU, u):
    """u: (B, *, W), the value branch → (a_t, beta_t · i_t · x_t), float32."""
    uf = u.to(torch.float32)
    rg = torch.sigmoid(uf @ p.w_a.to(torch.float32) + p.b_a)
    ig = torch.sigmoid(uf @ p.w_x.to(torch.float32) + p.b_x)
    log_a0 = elementwise(F.logsigmoid, p.lam)             # (W,) <= 0
    a = torch.exp(cfg.rglru.c_exponent * log_a0 * rg)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * ig * uf


def rglru_train(cfg, p: RGLRU, x):
    """x: (B, S, D) → (y (B, S, D), {"h": (B, W) float32, "conv": the last
    d_conv - 1 inputs of the conv (B, ·, W)})."""
    r = cfg.rglru
    B, S, _ = x.shape
    u_pre = x @ p.w_in
    u = conv_causal(p.conv_w, p.conv_b, u_pre, r.d_conv)
    gate = _gelu(x @ p.w_gate_branch)
    a, bx = _gates(cfg, p, u)                             # (B, S, W)

    chunk, Sp = chunks(S, r.scan_chunk)
    # identity steps past the end (a = 1, b = 0): an exact final state
    a = pad(a, (0, 0, 0, Sp - S), value=1.0)
    bx = pad(bx, (0, 0, 0, Sp - S))
    h = torch.zeros((B, r.lru_width), dtype=torch.float32, device=x.device)
    states = []
    for c0 in range(0, Sp, chunk):
        hs = scan_inplace(a[:, c0:c0 + chunk], bx[:, c0:c0 + chunk], h)
        states.append(hs)
        h = hs[:, -1]
    # serving's scan wrote the states over bx; training's returned them
    hseq = torch.cat(states, dim=1) if records_grad(a, bx) else bx
    y = hseq[:, :S].to(x.dtype) * gate
    state = {"h": h.clone(), "conv": u_pre[:, S - (r.d_conv - 1):]}
    return y @ p.w_out, state


def rglru_decode(cfg, p: RGLRU, x, state):
    """x: (B, 1, D); state: {"h": (B, W) float32, "conv": (B, d_conv - 1,
    W)}, updated in place and returned beside the output (B, 1, D)."""
    r = cfg.rglru
    window, conv = conv_window(p.conv_w, p.conv_b, state["conv"],
                               x @ p.w_in, r.d_conv)
    u = conv[:, None, :].to(x.dtype)
    gate = _gelu(x @ p.w_gate_branch)
    a, bx = _gates(cfg, p, u)                             # (B, 1, W)
    h = a[:, 0] * state["h"] + bx[:, 0]
    y = h[:, None, :].to(x.dtype) * gate
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return y @ p.w_out, state


def rglru_init_state(cfg, batch: int, device):
    r = cfg.rglru
    return {
        "h": torch.zeros((batch, r.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, r.d_conv - 1, r.lru_width),
                            dtype=dtype_of(cfg), device=device),
    }
