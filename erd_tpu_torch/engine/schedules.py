"""LR schedules; the counterpart of erd_tpu/engine/schedules.py for the
reference 1x recipe: linear warmup from ``warmup_factor`` over
``warmup_iters`` steps, then multi-step decay, and the linear
``auto_scale_lr`` rule."""
from __future__ import annotations

from typing import Callable, Sequence


def warmup_multistep(base_lr: float, warmup_iters: int = 500,
                     warmup_factor: float = 0.001,
                     milestones_steps: Sequence[int] = (),
                     gamma: float = 0.1) -> Callable[[int], float]:
    """Per-step schedule, the step counted from 0 as in optax; milestones
    are in steps."""
    milestones = sorted(int(m) for m in milestones_steps)

    def schedule(count: int) -> float:
        frac = min(max(count / max(warmup_iters, 1), 0.0), 1.0)
        warm = warmup_factor + (1.0 - warmup_factor) * frac
        decay = 1.0
        for m in milestones:
            if count >= m:
                decay *= gamma
        return base_lr * warm * decay

    return schedule


def auto_scale_lr(base_lr: float, batch_size: int,
                  base_batch_size: int = 16) -> float:
    """Linear LR scaling rule."""
    return base_lr * batch_size / base_batch_size
