"""L1 and smooth-L1 regression losses; the counterpart of
erd_tpu/losses/smooth_l1.py ``l1_loss`` and ``smooth_l1_loss``."""
from __future__ import annotations

import torch

from .utils import weight_reduce_loss


def l1_loss(pred, target, weight=None, reduction='mean', avg_factor=None):
    return weight_reduce_loss((pred - target).abs(), weight, reduction,
                              avg_factor)


def smooth_l1_loss(pred, target, weight=None, beta=1.0, reduction='mean',
                   avg_factor=None):
    """0.5 * d^2 / beta where d = |pred - target| < beta, else
    d - 0.5 * beta."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
