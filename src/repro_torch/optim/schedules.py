"""Learning-rate schedules (``repro/optim/schedules.py``): ``step -> lr``.

Computed in f32, as the JAX package's jitted schedules are, and
returned as a Python float.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def f32(x) -> torch.Tensor:
    """``x`` as an f32 scalar tensor, for scalar math done in f32."""
    return torch.tensor(x, dtype=torch.float32)


def constant_schedule(lr: float) -> Schedule:
    value = float(f32(lr))
    return lambda step: value


def linear_warmup_cosine(peak_lr: float, warmup_steps: int,
                         total_steps: int, *,
                         final_fraction: float = 0.0) -> Schedule:
    """Linear warm-up to ``peak_lr``, then a cosine to
    ``final_fraction * peak_lr``. Step 0 counts as step 1, so the first
    update does not have lr = 0."""
    def fn(step: int) -> float:
        s = f32(step) + 1.0
        warm = peak_lr * s / max(warmup_steps, 1)
        t = ((s - warmup_steps) / max(total_steps - warmup_steps, 1)
             ).clamp(0.0, 1.0)
        cos = peak_lr * (final_fraction + (1 - final_fraction) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return float(warm if s < warmup_steps else cos)
    return fn


def cosine_schedule(peak_lr: float, total_steps: int, *,
                    final_fraction: float = 0.1) -> Schedule:
    """A cosine from ``peak_lr`` at step 0 to ``final_fraction * peak_lr``
    at ``total_steps``, flat after it."""
    def fn(step: int) -> float:
        t = (f32(step) / total_steps).clamp(0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return float(peak_lr * (final_fraction + (1 - final_fraction) * cos))
    return fn


def linear_warmup_linear_decay(peak_lr: float, warmup_steps: int,
                               total_steps: int) -> Schedule:
    """Linear from 0 at step 0 to ``peak_lr`` at ``warmup_steps``, then
    linear to 0 at ``total_steps`` (0 after it)."""
    def fn(step: int) -> float:
        s = f32(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        decay = peak_lr * ((total_steps - s)
                           / max(total_steps - warmup_steps, 1)
                           ).clamp(0.0, 1.0)
        return float(warm if s < warmup_steps else decay)
    return fn
