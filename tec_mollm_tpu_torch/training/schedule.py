"""Learning-rate schedules, stepped once per optimizer update.

``cosine_annealing_warm_restarts`` drives the forecast model's training and
``warmup_cosine_decay`` the byte LM's pretraining.

The first is the reference's ``CosineAnnealingWarmRestarts(T_0=10, T_mult=2,
eta_min=1e-7)`` (``training/schedule.py`` of the JAX package), in closed form::

    lr(t) = eta_min + (base - eta_min) * (1 + cos(pi * T_cur / T_i)) / 2

with cycle lengths T_0, T_0*mult, T_0*mult^2, ... The cycle index comes from a
logarithm and is then corrected in integers, so a restart lands on its step
exactly.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_annealing_warm_restarts(
    base_lr: float, t_0: int = 10, t_mult: int = 2, eta_min: float = 1e-7
) -> Callable[[int], float]:
    """Returns schedule(step) -> lr for integer steps >= 0."""
    if t_0 <= 0:
        raise ValueError("t_0 must be positive")
    if t_mult < 1:
        raise ValueError("t_mult must be >= 1")

    def cycle_start(n: int) -> int:  # first step of cycle n
        return t_0 * (t_mult**n - 1) // (t_mult - 1)

    def schedule(step: int) -> float:
        step = int(step)
        if t_mult == 1:
            t_cur, t_i = step % t_0, t_0
        else:
            n = int(math.log(step * (t_mult - 1) / t_0 + 1.0, t_mult))
            while cycle_start(n + 1) <= step:
                n += 1
            while n > 0 and cycle_start(n) > step:
                n -= 1
            t_cur, t_i = step - cycle_start(n), t_0 * t_mult**n
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t_cur / t_i))

    return schedule


def warmup_cosine_decay(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine down to
    ``end_value`` at ``decay_steps`` (which counts the warm-up) and flat after.
    optax evaluates it at the 0-based update count, so the first update of the
    pretraining has rate ``init_value``."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(step: int) -> float:
        step = int(step)
        if step < warmup_steps:
            return init_value + (peak_value - init_value) * step / warmup_steps
        count = min(step - warmup_steps, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)

    return schedule
