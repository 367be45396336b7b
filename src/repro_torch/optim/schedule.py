"""Learning-rate schedules (pure functions of the step).

Each takes the step as an int or a 0-d tensor and returns a float32 0-d
tensor on the step's device, with the reference's float32 arithmetic."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = step / max(1.0, warmup_steps)
    progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    progress = torch.clamp(progress, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(
        math.pi * progress))
    return torch.where(step < warmup_steps, warm, cos)


def constant_with_warmup(step, *, warmup_steps: int) -> torch.Tensor:
    step = _step(step)
    return torch.clamp(step / max(1.0, warmup_steps), max=1.0)
