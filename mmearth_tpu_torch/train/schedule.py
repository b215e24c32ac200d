"""LR schedule: per-iteration linear warmup + half-cosine decay (port of
``mmearth_tpu/train/schedule.py``, the reference's ``adjust_learning_rate``,
helpers.py:647-665, called with a fractional epoch every iteration)."""
from __future__ import annotations

import math


def warmup_cosine(base_lr: float, min_lr: float, epochs: int, warmup_epochs: int,
                  steps_per_epoch: int):
    """``schedule(step) -> lr``; ``step`` counts optimizer updates (with
    gradient accumulation, pass steps_per_epoch = updates per epoch)."""

    def schedule(step: int) -> float:
        e = step / steps_per_epoch
        if e < warmup_epochs:
            return base_lr * e / max(warmup_epochs, 1e-8)
        progress = (e - warmup_epochs) / max(epochs - warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule
