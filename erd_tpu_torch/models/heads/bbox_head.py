"""R-CNN bbox head (Shared2FC) and its predict post-processing; the
counterpart of erd_tpu/models/heads/bbox_head.py (serving).

flatten (C, 7, 7) -> fc1024 -> fc1024 -> {``fc_cls`` over C + 1 classes,
background last; ``fc_reg`` class-specific 4C deltas, stds (0.1, 0.1, 0.2,
0.2)}. mmdet flattens the RoI features channel-major, erd_tpu (7, 7, C);
``weight_import.params_from_jax`` permutes ``shared_fcs.0``'s input rows,
so the port loads mmdet checkpoints by name. Training: the gt boxes join
the proposals as candidates, MaxIoU assignment (0.5 / 0.5, no low-quality
matches), 512 samples at a positive fraction 0.25 (``rcnn_sample``), then
the CE over C + 1 classes and the L1 of the deltas at the target label,
both divided by the count of valid samples (``rcnn_loss``), batched over B.
erd_tpu's OHEM sampler is not ported (``build_detector`` raises for it).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...losses import cross_entropy_int, l1_loss
from ...ops import nms_select_cfg
from ...ops.misc import NEG_INF, take_rows, topk_stable
from ...structures import DetResults, scale_boxes
from ...task import DeltaXYWHBBoxCoder, max_iou_assign, random_sample
from ..layers import Linear
from .gfl_head import GFLTestConfig


class Shared2FCBBoxHead(nn.Module):
    """mmdet names ``shared_fcs.{0,1}``, ``fc_cls``, ``fc_reg``.

    ``param_dtype`` rounds the weights (see ``layers.Linear``): the R-CNN
    head of a bf16 model computes float32 products of bf16 weights on its
    float32 RoI features, as erd_tpu's does.
    """

    def __init__(self, num_classes: int, in_channels: int = 256,
                 roi_size: int = 7, fc_dim: int = 1024,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            Linear(in_channels * roi_size * roi_size, fc_dim, param_dtype),
            Linear(fc_dim, fc_dim, param_dtype)])
        self.fc_cls = Linear(fc_dim, num_classes + 1, param_dtype)
        self.fc_reg = Linear(fc_dim, 4 * num_classes, param_dtype)

    def forward(self, roi_feats):
        """(N, C, 7, 7) -> (cls (N, C+1), reg (N, 4C))."""
        x = roi_feats.flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


@dataclass(frozen=True)
class RCNNTrainConfig:
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    min_pos_iou: float = 0.5
    num_samples: int = 512
    pos_fraction: float = 0.25
    cls_weight: float = 1.0
    bbox_weight: float = 1.0


@dataclass
class RoISamples:
    """Per-image fixed-size sampled RoIs and their targets, all (B, S,
    ...)."""
    rois: torch.Tensor    # (B, S, 4)
    labels: torch.Tensor  # (B, S) int64, num_classes = background
    deltas: torch.Tensor  # (B, S, 4) encoded targets (positives only)
    is_pos: torch.Tensor  # (B, S) bool
    valid: torch.Tensor   # (B, S) bool
    gt_idx: torch.Tensor  # (B, S) int64 assigned gt (positives only)


def rcnn_sample(proposals, prop_mask, gt, num_classes, coder,
                pos_keys, neg_keys, cfg: RCNNTrainConfig) -> RoISamples:
    """erd_tpu's ``rcnn_assign_single`` + ``rcnn_sample_single`` on a batch,
    with its ``add_gt_as_proposals`` (the gt boxes join ahead of the
    proposals as candidates).

    proposals (B, R, 4) and prop_mask (B, R) from ``rpn_proposals``; gt a
    GTInstances of (B, G, ...); pos_keys, neg_keys (B, G + R) uniform
    draws."""
    cand = torch.cat([gt.bboxes, proposals], 1)
    cand_mask = torch.cat([gt.mask, prop_mask], 1)
    res = max_iou_assign(cand, gt.bboxes, gt.labels, gt.mask,
                         pos_iou_thr=cfg.pos_iou_thr,
                         neg_iou_thr=cfg.neg_iou_thr,
                         min_pos_iou=cfg.min_pos_iou,
                         match_low_quality=False, valid_flags=cand_mask)
    pos_mask = res.pos_mask & cand_mask
    neg_mask = ~res.pos_mask & (res.labels != -2) & cand_mask
    sample = random_sample(pos_mask, neg_mask, pos_keys, neg_keys,
                           num=cfg.num_samples,
                           pos_fraction=cfg.pos_fraction)
    rois = take_rows(cand, sample.idx)
    gt_idx = torch.gather(res.gt_idx, 1, sample.idx)
    is_pos = sample.is_pos & sample.valid
    labels = torch.where(is_pos, torch.gather(res.labels, 1, sample.idx),
                         torch.full_like(gt_idx, num_classes))
    deltas = coder.encode(rois, take_rows(gt.bboxes, gt_idx))
    deltas = torch.nan_to_num(deltas, nan=0.0, posinf=0.0, neginf=0.0)
    return RoISamples(rois=rois, labels=labels, deltas=deltas, is_pos=is_pos,
                      valid=sample.valid, gt_idx=gt_idx)


def rcnn_loss(cls_logits, reg_preds, samples: RoISamples,
              cfg: RCNNTrainConfig = RCNNTrainConfig()):
    """cls_logits (B, S, C+1) and reg_preds (B, S, 4C) float32 -> dict(
    loss_cls, loss_bbox): the CE over the valid samples and the L1 of the
    deltas at the target label over the positives, both divided by the
    count of valid samples (mmdet's avg_factor, the sampled RoIs)."""
    labels = samples.labels.reshape(-1)
    valid = samples.valid.reshape(-1).float()
    is_pos = samples.is_pos.reshape(-1).float()
    n_valid = valid.sum().clamp(min=1.0)
    cls_logits = cls_logits.reshape(labels.shape[0], -1)
    ce = cross_entropy_int(cls_logits, labels)
    loss_cls = cfg.cls_weight * (ce * valid).sum() / n_valid
    reg = reg_preds.reshape(labels.shape[0], -1, 4)
    safe = labels.clamp(0, reg.shape[1] - 1)
    at_label = torch.take_along_dim(reg, safe[:, None, None], 1)[:, 0]
    l1 = l1_loss(at_label, samples.deltas.reshape(-1, 4),
                 reduction='none').sum(-1)
    loss_bbox = cfg.bbox_weight * (l1 * is_pos).sum() / n_valid
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)


def softmax(x, dim=-1):
    """exp(x - max) / sum, jax.nn.softmax's arithmetic (torch.softmax
    multiplies by the reciprocal of the sum)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def rcnn_predict(cls_logits, reg_preds, rois, roi_mask, meta, num_classes,
                 coder: DeltaXYWHBBoxCoder, cfg: GFLTestConfig,
                 rescale=True) -> DetResults:
    """Post-process a batch's RoI head outputs into detections.

    cls_logits (B, R, C+1) and reg_preds (B, R, 4C) float32; rois (B, R, 4)
    and roi_mask (B, R) from ``rpn_proposals``; ``meta`` holds (B, 2)
    img_shape and scale_factor. Per image: softmax (background last),
    per-class decode clipped to the image, the ``score_thr`` mask on valid
    RoIs, a stable top-``pre_nms_total`` over the R*C (RoI, class) pairs,
    rescale, then ``nms_select_cfg`` (hard or soft NMS).
    """
    b, r = cls_logits.shape[:2]
    scores = softmax(cls_logits)[..., :num_classes]
    deltas = reg_preds.reshape(b, r, num_classes, 4)
    boxes = coder.decode(rois[:, :, None, :], deltas,
                         max_shape=meta.img_shape)  # (B, R, C, 4)
    flat_scores = scores.reshape(b, r * num_classes)
    flat_boxes = boxes.reshape(b, r * num_classes, 4)
    labels = torch.arange(num_classes, device=rois.device).repeat(r)
    valid = roi_mask.repeat_interleave(num_classes, dim=-1) & \
        (flat_scores > cfg.score_thr)
    k = min(cfg.pre_nms_total, r * num_classes)
    top, idx = topk_stable(torch.where(valid, flat_scores,
                                       torch.full_like(flat_scores, NEG_INF)),
                           k)
    vmask = top > NEG_INF
    sel_boxes = take_rows(flat_boxes, idx)
    if rescale:
        sel_boxes = scale_boxes(sel_boxes, 1.0 / meta.scale_factor)
    out = nms_select_cfg(sel_boxes, torch.where(vmask, top,
                                                torch.zeros_like(top)),
                         labels[idx], cfg, valid_mask=vmask)
    return DetResults(*out, num_candidates=vmask.sum(dim=-1))
