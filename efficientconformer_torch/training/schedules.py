"""Learning-rate schedules as ``count -> lr`` functions.

Counterpart of efficientconformer_tpu/training/schedules.py (reference
models/schedules.py). ``count`` is the 0-based index of the optimizer
update; update i runs at s = i + 1, as the reference's scheduler (stepped
once before training) and optax's scale_by_learning_rate count give.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def constant_lr(lr_value: float) -> Schedule:
    return lambda count: float(lr_value)


def constant_with_decay_lr(lr_values: Sequence[float], decay_steps: Sequence[int]) -> Schedule:
    def fn(count):
        # count > decay_steps[i] selects lr_values[i + 1]
        return float(lr_values[sum(count > b for b in decay_steps)])
    return fn


def transformer_lr(dim_model: int, warmup_steps: int, k: float) -> Schedule:
    def fn(count):
        s = count + 1.0
        return k * dim_model ** -0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
    return fn


def exp_decay_transformer_lr(warmup_steps: int, lr_max: float, alpha: float,
                             end_step: int) -> Schedule:
    def fn(count):
        s = count + 1.0
        warm = s / warmup_steps * lr_max
        decay = lr_max * alpha ** ((s - warmup_steps) / (end_step - warmup_steps))
        return min(warm, decay)
    return fn


def cosine_annealing_lr(warmup_steps: int, lr_max: float, lr_min: float,
                        end_step: int) -> Schedule:
    def fn(count):
        s = count + 1.0
        if s <= warmup_steps:
            return s / warmup_steps * lr_max
        return (lr_max - lr_min) * 0.5 * (
            1.0 + math.cos(math.pi * (s - warmup_steps) / (end_step - warmup_steps))) + lr_min
    return fn


def _lr_max(p: dict) -> float:
    return p.get("lr_max") or p["K"] * p["schedule_dim"] ** -0.5 * p["warmup_steps"] ** -0.5


def from_training_params(p: dict) -> Schedule:
    """The schedule of reference-schema training_params."""
    name = p["lr_schedule"]
    if name == "Constant":
        return constant_lr(p["lr_value"])
    if name == "ConstantWithDecay":
        return constant_with_decay_lr(p["lr_values"], p["decay_steps"])
    if name == "Transformer":
        return transformer_lr(p["schedule_dim"], p["warmup_steps"], p["K"])
    if name == "ExpDecayTransformer":
        return exp_decay_transformer_lr(p["warmup_steps"], _lr_max(p), p["alpha"], p["end_step"])
    if name == "Cosine":
        return cosine_annealing_lr(p["warmup_steps"], _lr_max(p), p["lr_min"], p["end_step"])
    raise ValueError(f"unknown lr_schedule {name}")
