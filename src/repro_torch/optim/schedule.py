"""Learning-rate schedules of the port (counterpart of
``repro/optim/schedule.py``): plain functions of the step counter, an int
or a float, evaluated on the host."""

from __future__ import annotations

import math


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1) -> float:
    frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * frac))
    return final_frac + (1.0 - final_frac) * cos


def linear_warmup_cosine(step, warmup: int, total_steps: int, final_frac: float = 0.1) -> float:
    warm = min(step / max(warmup, 1), 1.0)
    return warm * cosine_schedule(max(step - warmup, 0), max(total_steps - warmup, 1), final_frac)
