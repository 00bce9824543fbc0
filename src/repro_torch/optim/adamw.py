"""AdamW with decoupled weight decay, global-norm clipping and float32
moments.

Port of ``repro.optim.adamw``: the reference's own formulas in float32
torch (not ``torch.optim.AdamW``, whose rounding differs). The trainable
leaves are a list of tensors (``models.trainable``: every floating leaf in
the reference's tree order, one tensor per layer where the reference
stacks the layers); the int8 codes never enter it.

    clip  = min(1, grad_clip / max(|g|, 1e-12))
    mu    = b1 mu + (1 − b1) g clip
    nu    = b2 nu + (1 − b2) (g clip)²
    delta = (mu / (1 − b1^t)) / (sqrt(nu / (1 − b2^t)) + eps) + wd p
    p     = (p − lr delta) in float32, cast back to p's dtype
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_state(params) -> dict:
    """float32 zero moments beside each trainable tensor, step 0 (int32)."""
    return {"mu": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in params],
            "nu": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in params],
            "step": torch.zeros((), dtype=torch.int32,
                                device=params[0].device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of Σ over the tensors, in order, of Σ g² in float32."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def update(p, g, mu, nu, cfg: AdamWConfig, *, clip, bc1, bc2, lr):
    """One leaf's (new p in p's dtype, new mu, new nu): new tensors."""
    g = g.to(torch.float32) * clip
    mu = cfg.b1 * mu + (1.0 - cfg.b1) * g
    nu = cfg.b2 * nu + (1.0 - cfg.b2) * g * g
    pf = p.detach().to(torch.float32)
    delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps) \
        + cfg.weight_decay * pf
    return (pf - lr * delta).to(p.dtype), mu, nu


def prepare(grads, state: dict, cfg: AdamWConfig, lr_scale=1.0) -> dict:
    """The step's scalars, float32 tensors on the grads' device: the next
    ``step``, ``grad_norm``, ``clip``, the bias corrections ``bc1``/``bc2``
    and ``lr``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    one = _f32(1.0, gnorm)
    clip = torch.minimum(one, cfg.grad_clip
                         / torch.clamp(gnorm, min=1e-12))
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, gnorm), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, gnorm), t)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)
    return {"step": step, "grad_norm": gnorm, "clip": clip, "bc1": bc1,
            "bc2": bc2, "lr": lr}


def apply_updates(params, grads, state: dict, cfg: AdamWConfig,
                  lr_scale=1.0):
    """Returns (new params, new state, {"grad_norm"}), new tensors; the
    caller's are left as they are."""
    s = prepare(grads, state, cfg, lr_scale)
    out = [update(p, g, m, n, cfg, clip=s["clip"], bc1=s["bc1"],
                  bc2=s["bc2"], lr=s["lr"])
           for p, g, m, n in zip(params, grads, state["mu"], state["nu"])]
    return ([o[0] for o in out],
            {"mu": [o[1] for o in out], "nu": [o[2] for o in out],
             "step": s["step"]},
            {"grad_norm": s["grad_norm"]})
