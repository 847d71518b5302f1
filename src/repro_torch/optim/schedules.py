"""Learning-rate schedules (the port's copy of ``repro.optim.schedules``):
pure functions of the step counter, evaluated in f32 as ``repro``'s are.
A schedule takes an int or a 0-d tensor and returns a 0-d f32 tensor on
the step's device (the CPU for an int)."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        lin = peak_lr * torch.clamp(1.0 - frac, 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, lin)

    return schedule


def constant(lr: float):
    def schedule(step):
        return torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)

    return schedule
