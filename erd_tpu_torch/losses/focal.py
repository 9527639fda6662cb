"""Sigmoid focal loss; the counterpart of erd_tpu/losses/focal.py
``sigmoid_focal_loss`` (the DETR family's classification loss)."""
from __future__ import annotations

import torch

from .utils import binary_cross_entropy_with_logits, weight_reduce_loss


def sigmoid_focal_loss(pred, target, weight=None, gamma=2.0, alpha=0.25,
                       reduction='mean', avg_factor=None):
    """Focal loss on logits, summed over the classes of each row.

    Args:
        pred: (N, C) logits.
        target: (N,) int labels in [0, C], C meaning background, or (N, C)
            binary targets.
        weight: (N,) row weights.
    """
    num_classes = pred.shape[-1]
    if target.dim() == pred.dim() - 1:
        onehot = torch.nn.functional.one_hot(
            target.long().clamp(0, num_classes),
            num_classes + 1)[..., :num_classes].to(pred.dtype)
    else:
        onehot = target.to(pred.dtype)
    p = torch.sigmoid(pred)
    pt = (1 - p) * onehot + p * (1 - onehot)
    focal_weight = (alpha * onehot + (1 - alpha) * (1 - onehot)) * \
        torch.pow(pt, gamma)
    loss = binary_cross_entropy_with_logits(pred, onehot) * focal_weight
    return weight_reduce_loss(loss.sum(-1), weight, reduction, avg_factor)
