"""LR schedules (port of ``repro/optim/schedule.py``): functions of the
step counter, in float32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio.  ``step``: an int or
    a tensor (the optimizer's int32 counter); returns a float32 scale in
    (0, 1] on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
