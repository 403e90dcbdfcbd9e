"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def cosine_warmup(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """lr(step): linear from 0 to ``peak_lr`` over ``warmup`` steps, then a
    cosine down to ``floor * peak_lr`` at ``total``; ``step`` an int or a
    tensor, the result a float32 tensor on its device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr
