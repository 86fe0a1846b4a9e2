"""Learning-rate schedules (the port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor_frac * peak_lr`` at ``total``.  ``step`` is a 0-dim
    integer tensor (or a number); the rate is a 0-dim float32 tensor on
    its device, computed in ``repro``'s order of float32 operations."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
