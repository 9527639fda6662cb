"""Training hooks; the counterpart of erd_tpu/engine/hooks.py (``Hook``,
``LoggerHook``, ``CheckInvalidLossHook``).

The trainer hands every hook the host loss scalars of every iteration.
"""
from __future__ import annotations

import logging
import math
import time
from collections import deque
from typing import Dict

log = logging.getLogger('erd_tpu_torch')


class Hook:

    def before_train(self, trainer):
        pass

    def before_epoch(self, trainer, epoch):
        """Called before the epoch with 0-based index ``epoch`` runs."""

    def after_iter(self, trainer, step, losses: Dict[str, float]):
        pass

    def after_epoch(self, trainer, epoch):
        pass


class LoggerHook(Hook):
    """Loss and throughput, averaged over the last 50 iterations, logged
    every ``interval`` iterations (the reference's LogProcessor)."""

    WINDOW = 50

    def __init__(self, interval=50):
        self.interval = interval
        self._times = deque(maxlen=self.WINDOW)
        self._losses = deque(maxlen=self.WINDOW)
        self._t0 = None

    def before_train(self, trainer):
        self._t0 = time.perf_counter()

    def after_iter(self, trainer, step, losses):
        t = time.perf_counter()
        self._times.append(t - self._t0)
        self._t0 = t
        self._losses.append(losses)
        if (step + 1) % self.interval:
            return
        avg_t = sum(self._times) / len(self._times)
        avg = {k: sum(d[k] for d in self._losses) / len(self._losses)
               for k in losses}
        lr = trainer.current_lr(step)
        ips = trainer.global_batch_size / max(avg_t, 1e-9)
        log.info(f'iter {step + 1} lr {lr:.3e} time {avg_t * 1000:.0f}ms '
                 f'({ips:.1f} img/s) ' +
                 ' '.join(f'{k} {v:.4f}' for k, v in avg.items()))


class CheckInvalidLossHook(Hook):
    """Raise on a non-finite total loss every ``interval`` iterations."""

    def __init__(self, interval=50):
        self.interval = interval

    def after_iter(self, trainer, step, losses):
        if (step + 1) % self.interval == 0 and \
                not math.isfinite(sum(losses.values())):
            raise FloatingPointError(
                f'non-finite loss at iter {step + 1}: {losses}')
