"""Varifocal loss; the counterpart of erd_tpu/losses/extra.py
``varifocal_loss`` (VFNet's classification loss)."""
from __future__ import annotations

import torch

from .utils import binary_cross_entropy_with_logits, weight_reduce_loss


def varifocal_loss(pred, target, weight=None, alpha=0.75, gamma=2.0,
                   iou_weighted=True, reduction='mean', avg_factor=None):
    """Varifocal loss on logits against an IoU-aware score map.

    Args:
        pred: (N, C) logits.
        target: (N, C) targets, the IoU at the true class of a positive and
            0 elsewhere.
    A positive entry (target > 0) weighs its BCE by its target
    (``iou_weighted``) or by 1; a negative one by alpha * |p - target|^gamma.
    The focal weight is not detached, as in erd_tpu.
    """
    p = torch.sigmoid(pred)
    target = target.to(pred.dtype)
    pos = (target > 0).to(pred.dtype)
    lead = target * pos if iou_weighted else pos
    focal_weight = lead + alpha * torch.pow(torch.abs(p - target), gamma) * \
        (1 - pos)
    loss = binary_cross_entropy_with_logits(pred, target) * focal_weight
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
