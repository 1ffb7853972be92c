"""LR schedule: linear warmup from min_lr, then one cosine cycle down to min_lr.

Counterpart of ``clip_mixer_tpu/train/schedule.py``. The optimiser reads it
at its update count before incrementing it, as optax does, so the first
update uses ``min_lr``.
"""

from __future__ import annotations

import math


def warmup_cosine(max_lr: float, min_lr: float, warmup_steps: int, total_steps: int):
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return min_lr + (max_lr - min_lr) * step / max(warmup_steps, 1)
        prog = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (max_lr - min_lr) * (1.0 + math.cos(math.pi * prog))

    return schedule
