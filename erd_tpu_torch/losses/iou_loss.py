"""GIoU box loss; the counterpart of erd_tpu/losses/iou_loss.py
``giou_loss`` (an (N, 4) weight collapses to (N,) by its mean)."""
from __future__ import annotations

from ..structures.boxes import bbox_overlaps
from .utils import weight_reduce_loss


def giou_loss(pred, target, weight=None, eps=1e-7, reduction='mean',
              avg_factor=None):
    gious = bbox_overlaps(pred, target, mode='giou', is_aligned=True,
                          eps=eps)
    loss = 1 - gious
    if weight is not None and weight.dim() == loss.dim() + 1:
        weight = weight.mean(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
