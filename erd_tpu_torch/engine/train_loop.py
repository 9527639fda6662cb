"""The training loop; the counterpart of erd_tpu/engine/train_loop.py
(``TrainerConfig``, ``Trainer``) on one device.

Each iteration: the schedule's learning rate, the detector's loss (with the
frozen teacher for ERD), one backward, one SGD step, then every hook with
the host loss scalars.

The loader protocol is erd_tpu's: ``loader.cfg.batch_size``,
``loader.steps_per_epoch(epoch)`` and ``loader.epoch(epoch)`` yielding
``dict(images (B, H, W, 3) uint8, gt: GTInstances, meta: ImageMeta)`` of
numpy arrays or tensors; the trainer moves each batch to its device.
"""
from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..utils import resolve_device
from .hooks import CheckInvalidLossHook, Hook, LoggerHook
from .optim import sgd_optimizer
from .schedules import auto_scale_lr, warmup_multistep

log = logging.getLogger('erd_tpu_torch')


@dataclass
class TrainerConfig:
    epochs: int = 12
    base_lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_iters: int = 500
    warmup_factor: float = 0.001
    milestones_epochs: tuple = (8, 11)
    gamma: float = 0.1
    auto_scale_base_batch: int = 16
    log_interval: int = 50


def _to(value, device):
    if value is None:
        return None
    return torch.as_tensor(value).to(device, non_blocking=True)


def batch_to(batch, device):
    """A loader batch with every array (and dataclass field) on
    ``device``."""
    out = {}
    for key, value in batch.items():
        if dataclasses.is_dataclass(value):
            out[key] = type(value)(**{
                f.name: _to(getattr(value, f.name), device)
                for f in dataclasses.fields(value)})
        else:
            out[key] = _to(value, device)
    return out


class Trainer:
    """Drives ``detector.loss`` with SGD; epoch-based.

    ``teacher`` is the frozen ERD teacher network (None for plain GFL
    training). The device is ``cuda`` unless the caller names one; without
    CUDA the trainer raises.
    """

    def __init__(self, detector, train_loader, cfg: TrainerConfig,
                 teacher=None, hooks: Optional[List[Hook]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.det = detector
        # one device: the ERD distillation sums carry no 1/num_devices
        erd_cfg = getattr(detector, 'erd', None)
        if erd_cfg is not None and erd_cfg.num_devices != 1:
            log.info('deriving ERD num_devices=1 (detector was built with '
                     '%d)', erd_cfg.num_devices)
            self.det = dataclasses.replace(
                detector, erd=dataclasses.replace(erd_cfg, num_devices=1))
        self.loader = train_loader
        self.cfg = cfg
        self.teacher = teacher
        self.hooks = hooks if hooks is not None else [
            LoggerHook(cfg.log_interval), CheckInvalidLossHook()]
        self.global_batch_size = train_loader.cfg.batch_size
        self.steps_per_epoch = train_loader.steps_per_epoch(0)
        lr = auto_scale_lr(cfg.base_lr, self.global_batch_size,
                           cfg.auto_scale_base_batch)
        self.schedule = warmup_multistep(
            lr, cfg.warmup_iters, cfg.warmup_factor,
            [m * self.steps_per_epoch for m in cfg.milestones_epochs],
            cfg.gamma)
        self.optimizer = None

    def current_lr(self, step):
        return float(self.schedule(step))

    def train_step(self, net, batch, step):
        """One SGD step on a batch already on the device; returns the
        host loss scalars."""
        for group in self.optimizer.param_groups:
            group['lr'] = self.current_lr(step)
        self.optimizer.zero_grad(set_to_none=True)
        if self.teacher is not None:
            losses = self.det.loss(net, batch, teacher=self.teacher)
        else:
            losses = self.det.loss(net, batch)
        sum(losses.values()).backward()
        self.optimizer.step()
        values = torch.stack([v.detach().float() for v in losses.values()])
        return dict(zip(losses, values.tolist()))

    def fit(self, net):
        """Train ``net`` (the student) in place on the trainer's device and
        return it."""
        net = net.to(self.device)
        if self.teacher is not None:
            self.teacher = self.teacher.to(self.device).requires_grad_(False)
        self.optimizer = sgd_optimizer(net, self.current_lr(0),
                                       self.cfg.momentum,
                                       self.cfg.weight_decay)
        for h in self.hooks:
            h.before_train(self)
        step = 0
        for epoch in range(self.cfg.epochs):
            log.info(f'epoch {epoch + 1}/{self.cfg.epochs}')
            for h in self.hooks:
                h.before_epoch(self, epoch)
            for batch in self.loader.epoch(epoch):
                losses = self.train_step(net, batch_to(batch, self.device),
                                         step)
                for h in self.hooks:
                    h.after_iter(self, step, losses)
                step += 1
            for h in self.hooks:
                h.after_epoch(self, epoch)
        return net
