"""Learning-rate schedules: pure functions of the step count tensor
(port of ``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda count: torch.tensor(value, dtype=torch.float32,
                                      device=count.device)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(count):
        frac = torch.clamp(count.float() / max(warmup_steps, 1), max=1.0)
        return peak * frac
    return fn


def cosine_decay(init: float, decay_steps: int, alpha: float = 0.0):
    def fn(count):
        frac = torch.clamp(count.float() / max(decay_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return init * ((1 - alpha) * cos + alpha)
    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(count):
        c = count.float()
        warm = peak * c / max(warmup_steps, 1)
        frac = torch.clamp((c - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(c < warmup_steps, warm, cos)
    return fn
