"""LR schedules (paper: cosine with lr = 1e-3).

Counterpart of ``repro/optim/schedule.py``, on the host: the step is a
Python int, so the learning rate is a Python float and needs no device.
"""

from __future__ import annotations

import math

__all__ = ["cosine_schedule"]


def cosine_schedule(step: int, *, base_lr: float, total_steps: int,
                    warmup_steps: int = 0, min_lr_ratio: float = 0.0) -> float:
    """Linear warm-up from 0 over ``warmup_steps``, then a cosine decay to
    ``min_lr_ratio · base_lr`` at ``total_steps``."""
    if step < warmup_steps:
        return base_lr * step / max(warmup_steps, 1)
    prog = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return base_lr * (min_lr_ratio + (1 - min_lr_ratio) * cos)
