"""LR schedules (pure functions of the step counter).

Counterpart of :mod:`repro.optim.schedules`, in float32 tensors on the
step's device."""

from __future__ import annotations

import math

import torch


def warmup_cosine(
    step,
    peak_lr: float,
    warmup_steps: int = 1000,
    decay_steps: int = 100_000,
    end_lr_ratio: float = 0.1,
) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``end_lr_ratio * peak_lr`` at ``decay_steps`` -> a 0-d float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
    cos = end_lr_ratio + (1 - end_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
