"""MaxIoU assigner (the Faster R-CNN family); the counterpart of
erd_tpu/task/max_iou.py ``max_iou_assign``, batched over leading dims.

An anchor whose best IoU is >= ``pos_iou_thr`` is positive, < ``neg_iou_thr``
negative, in between ignored (label -2). With ``match_low_quality`` every
anchor that ties a gt's best IoU (>= ``min_pos_iou``) is forced positive to
that gt, the highest-index gt winning (erd_tpu's ``argmax`` over the
reversed gt axis; torch has no negative-step slice, so the axis is
flipped), even over an anchor already positive.
"""
from __future__ import annotations

import torch

from ..structures.boxes import bbox_overlaps
from .atss import AssignResult


def max_iou_assign(anchors, gt_bboxes, gt_labels, gt_mask, pos_iou_thr=0.5,
                   neg_iou_thr=0.4, min_pos_iou=0.0, match_low_quality=True,
                   valid_flags=None):
    """anchors (..., N, 4) or (N, 4); gt_bboxes (..., G, 4), gt_labels and
    gt_mask (..., G); valid_flags (..., N) or None.

    Returns AssignResult(pos_mask, gt_idx int64, max_overlaps, labels int64:
    the gt's label for positives, -1 negatives, -2 ignored), each (..., N).
    """
    neg = torch.full((), -1.0, device=gt_bboxes.device)
    overlaps = bbox_overlaps(anchors, gt_bboxes)  # (..., N, G)
    overlaps = torch.where(gt_mask[..., None, :], overlaps, neg)
    if valid_flags is not None:
        overlaps = torch.where(valid_flags[..., :, None], overlaps, neg)
    max_overlaps, gt_idx = overlaps.max(dim=-1)  # first maximum on ties
    pos_mask = max_overlaps >= pos_iou_thr
    ignore_mask = (max_overlaps >= neg_iou_thr) & (max_overlaps < pos_iou_thr)
    if match_low_quality:
        gt_best = overlaps.amax(dim=-2)  # (..., G)
        force = gt_mask & (gt_best >= min_pos_iou) & (gt_best > -1.0)
        eligible = (overlaps == gt_best[..., None, :]) & force[..., None, :]
        forced_pos = eligible.any(dim=-1)
        g = gt_bboxes.shape[-2]
        last_idx = (g - 1) - eligible.flip(-1).to(torch.uint8).argmax(dim=-1)
        gt_idx = torch.where(forced_pos, last_idx, gt_idx)
        pos_mask = pos_mask | forced_pos
        ignore_mask = ignore_mask & ~forced_pos
    labels = torch.where(pos_mask,
                         torch.take_along_dim(gt_labels.long(), gt_idx, -1),
                         torch.full_like(gt_idx, -1))
    labels = torch.where(ignore_mask & ~pos_mask, torch.full_like(labels, -2),
                         labels)
    return AssignResult(pos_mask=pos_mask, gt_idx=gt_idx,
                        max_overlaps=max_overlaps, labels=labels)
