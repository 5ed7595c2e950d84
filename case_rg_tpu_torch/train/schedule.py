"""LR schedules (port of ``case_rg_tpu/train/schedule.py``).

``cosine_hard_restarts_with_warmup`` reproduces transformers'
``get_cosine_with_hard_restarts_schedule_with_warmup``: linear warmup, then
a cosine decay to zero in each of ``num_cycles`` cycles.
"""

from __future__ import annotations

import math


def cosine_hard_restarts_with_warmup(base_lr: float, warmup_steps: int,
                                     total_steps: int, num_cycles: int = 1):
    warmup = max(warmup_steps, 1)
    total = max(total_steps, warmup + 1)

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        progress = (step - warmup) / float(total - warmup)
        if progress >= 1.0:
            return 0.0
        cyc = (num_cycles * progress) % 1.0
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * cyc)))

    return schedule
