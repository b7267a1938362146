"""LR schedules matching the reference pairings (the JAX package's
``optim/schedules.py``), as functions of the update step.

The reference steps its torch schedulers once per epoch; these take
``steps_per_epoch`` and quantize internally.  ``one_cycle`` reproduces
``optax.cosine_onecycle_schedule`` (a ``piecewise_interpolate_schedule``
with cosine interpolation between the accumulated scaled values)
formula for formula, and ``multistep`` ``optax.piecewise_constant_
schedule``.  Values are python floats computed in float64 on the host, so
the step never waits on the card for its learning rate.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np

Schedule = Callable[[int], float]


def constant(value: float) -> Schedule:
    return lambda step: float(value)


def piecewise_constant(init_value: float,
                       boundaries_and_scales: Dict[int, float]) -> Schedule:
    """optax.piecewise_constant_schedule: init_value times every scale
    whose boundary the step has reached."""
    items = sorted(boundaries_and_scales.items())

    def schedule(step):
        v = float(init_value)
        for b, s in items:
            v = v * (1.0 if step < b else float(s))
        return v
    return schedule


def piecewise_cosine(init_value: float,
                     boundaries_and_scales: Dict[int, float]) -> Schedule:
    """optax.piecewise_interpolate_schedule('cosine', ...): cosine
    interpolation between the ACCUMULATED values at the boundaries, held
    at the last value past the end."""
    boundaries, scales = zip(*sorted(boundaries_and_scales.items()))
    bounds = np.array((0,) + boundaries)
    values = np.cumprod(np.array((init_value,) + scales, dtype=np.float64))
    sizes = bounds[1:] - bounds[:-1]

    def schedule(step):
        indicator = (bounds[:-1] <= step) & (step < bounds[1:])
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (step - bounds[:-1]) / sizes
        start, end = values[:-1], values[1:]
        interp = end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)
        return float(indicator.dot(interp)
                     + (bounds[-1] <= step) * values[-1])
    return schedule


def multistep(base_lr: float, milestones: Sequence[int] = (10, 20),
              gamma: float = 0.2, steps_per_epoch: int = 1) -> Schedule:
    """MultiStepLR([10, 20], 0.2)."""
    return piecewise_constant(
        base_lr, {int(m) * steps_per_epoch: gamma for m in milestones})


def cosine_annealing(base_lr: float, t_max: int = 200,
                     steps_per_epoch: int = 1,
                     eta_min: float = 0.0) -> Schedule:
    """CosineAnnealingLR(T_max=200)."""
    def schedule(step):
        epoch = step / steps_per_epoch
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * min(epoch, t_max) / t_max))
    return schedule


def one_cycle(base_lr: float, epochs: int, steps_per_epoch: int,
              max_lr_factor: float = 5.0, pct_start: float = 0.3,
              div_factor: float = 25.0,
              final_div_factor: float = 1e4) -> Schedule:
    """OneCycleLR(max_lr = 5 lr) spread over every update step:
    optax.cosine_onecycle_schedule(total, peak, pct_start, div_factor,
    final_div_factor)."""
    total = max(1, epochs * steps_per_epoch)
    peak = base_lr * max_lr_factor
    return piecewise_cosine(
        peak / div_factor,
        {int(pct_start * total): div_factor,
         int(total): 1.0 / (div_factor * final_div_factor)})


def step_decay(base_lr: float, step_size: int = 2, gamma: float = 0.2,
               steps_per_epoch: int = 1) -> Schedule:
    """StepLR(2, gamma)."""
    def schedule(step):
        epoch = step // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size)
    return schedule
