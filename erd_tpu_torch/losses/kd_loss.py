"""Knowledge-distillation KL loss and the ERD L2 response loss; the
counterpart of erd_tpu/losses/kd_loss.py.

KD: ``KL(softmax(teacher/T) || log_softmax(student/T)) * T^2``, the
element-wise KL averaged over the bin axis, teacher detached, 0 * log 0 = 0.
"""
from __future__ import annotations

import torch

from .utils import reduce_loss, weight_reduce_loss


def knowledge_distillation_kl_div_loss(pred, soft_label, weight=None, T=10,
                                       detach_target=True, reduction='mean',
                                       avg_factor=None):
    """Per-row KL distillation loss; pred and soft_label (N, bins)."""
    if pred.shape != soft_label.shape:
        raise ValueError('pred and soft_label must have one shape')
    target = torch.softmax(soft_label / T, dim=-1)
    if detach_target:
        target = target.detach()
    log_p = torch.log_softmax(pred / T, dim=-1)
    elem = torch.where(target > 0,
                       target * (torch.log(target.clamp(min=1e-30)) - log_p),
                       -target * log_p)
    kd = elem.mean(dim=-1) * (T * T)
    return weight_reduce_loss(kd, weight, reduction, avg_factor)


def l2_response_loss(pred, target, mask=None, reduction='mean'):
    """Element-wise squared error; with ``mask`` (broadcastable bool) the
    mean runs over the masked elements only."""
    if pred.shape != target.shape:
        raise ValueError('pred and target must have one shape')
    sq = (pred - target.detach()).square()
    if mask is not None:
        mask = mask.expand_as(sq).to(sq.dtype)
        if reduction == 'mean':
            return (sq * mask).sum() / mask.sum().clamp(min=1.0)
        if reduction == 'sum':
            return (sq * mask).sum()
        return sq * mask
    return reduce_loss(sq, reduction)
