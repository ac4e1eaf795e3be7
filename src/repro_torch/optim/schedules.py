"""LR schedules (pure functions of the step), the counterpart of
``repro/optim/schedules.py``: float32 scalars from an integer step
tensor."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, floor: float = 0.1):
    s = torch.as_tensor(step).float()
    warm = s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_):
    return torch.full_like(torch.as_tensor(step), peak_lr,
                           dtype=torch.float32)
