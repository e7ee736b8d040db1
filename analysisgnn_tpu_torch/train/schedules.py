"""Learning-rate schedules (counterpart of
``analysisgnn_tpu/train/schedules.py``), each a plain function of the step, in
float32 as the JAX package computes them: linear warmup from
``warmup_start_lr``, then cosine annealing to ``base_lr * eta_min_ratio``
(:func:`warmup_cosine_schedule`); or linear warmup from 0, then exponential
decay by ``gamma`` every ``decay_steps``, floored at ``eta_min``
(:func:`warmup_exponential_schedule`)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def warmup_cosine_schedule(
    base_lr: float,
    total_steps: int,
    warmup_steps: Optional[int] = None,
    warmup_start_lr: float = 0.0,
    eta_min_ratio: float = 0.01,
) -> Callable[[int], float]:
    if warmup_steps is None:
        warmup_steps = min(500, max(total_steps // 20, 1))
    eta_min = base_lr * eta_min_ratio
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(warmup_start_lr) + f32(base_lr - warmup_start_lr) * (step / f32(max(warmup_steps, 1))))
        progress = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        return float(f32(eta_min) + f32(0.5 * (base_lr - eta_min)) * (f32(1) + np.cos(f32(np.pi) * progress)))

    return schedule


def warmup_exponential_schedule(
    base_lr: float,
    decay_steps: int,
    warmup_steps: int = 500,
    gamma: float = 0.999,
    eta_min: float = 0.0,
) -> Callable[[int], float]:
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(base_lr) * step / f32(max(warmup_steps, 1)))
        decay = f32(base_lr) * f32(gamma) ** ((step - f32(warmup_steps)) / f32(decay_steps))
        return float(max(decay, f32(eta_min)))

    return schedule
