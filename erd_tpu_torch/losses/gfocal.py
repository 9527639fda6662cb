"""Quality Focal Loss and Distribution Focal Loss; the counterpart of
erd_tpu/losses/gfocal.py (dense one-hot form, no dynamic indexing)."""
from __future__ import annotations

import torch

from .utils import (binary_cross_entropy_with_logits, cross_entropy_int,
                    weight_reduce_loss)


def quality_focal_loss(pred, target, weight=None, beta=2.0, reduction='mean',
                       avg_factor=None):
    """QFL with (label, score) targets.

    Args:
        pred: (N, C) joint cls-quality logits.
        target: (labels (N,) int in [0, C], C = background; quality
            scores (N,) float, 0 for background).
        weight: optional (N,) weights.
    """
    labels, score = target
    num_classes = pred.shape[-1]
    pred_sigmoid = torch.sigmoid(pred)
    neg_loss = binary_cross_entropy_with_logits(
        pred, torch.zeros_like(pred)) * pred_sigmoid.pow(beta)
    pos_mask = (labels >= 0) & (labels < num_classes)
    safe = labels.clamp(0, num_classes - 1).long()
    onehot = torch.nn.functional.one_hot(safe, num_classes).bool()
    onehot = onehot & pos_mask[..., None]
    score_b = score[..., None].expand_as(pred)
    pos_loss = binary_cross_entropy_with_logits(pred, score_b) * (
        score_b - pred_sigmoid).abs().pow(beta)
    loss = torch.where(onehot, pos_loss, neg_loss).sum(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def distribution_focal_loss(pred, label, weight=None, reduction='mean',
                            avg_factor=None):
    """DFL: CE to the two integer bins bracketing the continuous target.

    pred (N, n+1) logits over bins {0..n}; label (N,) targets in [0, n).
    """
    dis_left = torch.floor(label).long()
    dis_right = dis_left + 1
    weight_left = dis_right.to(label.dtype) - label
    weight_right = label - dis_left.to(label.dtype)
    nbins = pred.shape[-1]
    loss = (cross_entropy_int(pred, dis_left.clamp(0, nbins - 1)) *
            weight_left +
            cross_entropy_int(pred, dis_right.clamp(0, nbins - 1)) *
            weight_right)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
