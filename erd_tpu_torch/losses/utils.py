"""Loss weighting and reduction; the counterpart of erd_tpu/losses/utils.py.

Every loss takes ``(pred, target, weight=None, reduction='mean',
avg_factor=None)`` and reduces through :func:`weight_reduce_loss`: with
``avg_factor`` and reduction 'mean' the loss is
``sum(loss * weight) / (avg_factor + eps)``, eps the float32 machine epsilon.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


def reduce_loss(loss, reduction):
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'unknown reduction {reduction!r}')


def weight_reduce_loss(loss, weight=None, reduction='mean', avg_factor=None):
    """Apply an element-wise weight, then reduce (reference semantics:
    mean with ``avg_factor`` is sum / (avg_factor + eps); ``avg_factor``
    with reduction 'sum' is an error)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == 'mean':
        return loss.sum() / (avg_factor + EPS)
    if reduction == 'none':
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


def binary_cross_entropy_with_logits(pred, target):
    """Numerically stable element-wise BCE on logits (no reduction)."""
    return (pred.clamp(min=0) - pred * target +
            torch.log1p(torch.exp(-pred.abs())))


def cross_entropy_int(logits, labels, dim=-1):
    """Element-wise CE with integer labels: logsumexp(x) - x[label]."""
    lse = torch.logsumexp(logits, dim=dim)
    picked = torch.gather(logits, dim, labels.long().unsqueeze(dim))
    return lse - picked.squeeze(dim)
