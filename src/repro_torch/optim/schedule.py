"""Learning-rate schedules of the step counter, float32 tensors (port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_ratio``: a scale in
    (0, 1]."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, value: float = 1.0) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32,
                        device=torch.as_tensor(step).device)
