"""LR schedules (the port of the reference package's `optim/schedule.py`)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak: float, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak`, cosine decay to floor*peak by `total`: a
    float32 scalar on `step`'s device (a tensor, or a number on the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
