"""Learning-rate schedules (time/step decay, exponential, warmup+cosine).

Each schedule maps the optimiser's 0-d int32 step tensor to a learning
rate, on the step's device.
"""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def step_decay(lr0: float, decay: float, every: int):
    """lr0 * decay^(step // every) — the paper's 'time based (or step based)'."""
    return lambda step: lr0 * decay ** torch.div(step, every,
                                                 rounding_mode="floor")


def exponential_decay(lr0: float, rate: float):
    """lr0 * exp(-rate * step) — Xu (2011) exponential decay."""
    return lambda step: lr0 * torch.exp(-rate * step.to(torch.float32))


def inverse_time_decay(lr0: float, rate: float):
    return lambda step: lr0 / (1.0 + rate * step.to(torch.float32))


def warmup_cosine(lr_peak: float, warmup: int, total: int, lr_min: float = 0.0):
    def fn(step):
        s = step.to(torch.float32)
        warm = lr_peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr_min + 0.5 * (lr_peak - lr_min) * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return fn
