"""RPN head: objectness and deltas, proposal generation and the RPN loss;
the counterpart of erd_tpu/models/heads/rpn_head.py.

Anchors: scale 8, ratios 0.5 / 1 / 2 on strides 4-64. Proposals per image:
a stable top-``nms_pre`` per level by sigmoid score, delta decode clipped to
the image, the ``min_bbox_size`` filter, then NMS with the level as the
class (mmdet 3.x) into ``max_per_img`` padded slots, all fixed-shape.
``rpn_loss``: MaxIoU assignment of the anchors, random sampling of 256 an
image on the caller's uniform draws, the objectness BCE and the L1 of the
deltas.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...losses import binary_cross_entropy_with_logits, l1_loss
from ...ops import nms_select
from ...ops.misc import take_rows, topk_stable
from ...task import (AnchorGenerator, DeltaXYWHBBoxCoder, max_iou_assign,
                     random_sample, valid_flags)
from ..layers import Conv2d
from .gfl_head import AnchorContext


def rpn_anchor_generator() -> AnchorGenerator:
    return AnchorGenerator(strides=(4, 8, 16, 32, 64),
                           ratios=(0.5, 1.0, 2.0), octave_base_scale=8,
                           scales_per_octave=1)


class RPNHeadNet(nn.Module):
    """Shared 3x3 conv + ReLU, then 1x1 objectness and delta convs; mmdet
    names ``rpn_conv``, ``rpn_cls``, ``rpn_reg``. Returns per-level
    (objectness in the compute dtype, deltas in float32), NHWC: channel
    ``a`` of cell (h, w) is anchor ``(h * W + w) * A + a``."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_base_anchors: int = 3):
        super().__init__()
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3)
        self.rpn_cls = Conv2d(feat_channels, num_base_anchors, 1)
        self.rpn_reg = Conv2d(feat_channels, num_base_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        outs_cls, outs_reg = [], []
        for x in feats:
            y = F.relu(self.rpn_conv(x))
            outs_cls.append(self.rpn_cls(y).permute(0, 2, 3, 1))
            outs_reg.append(self.rpn_reg(y).float().permute(0, 2, 3, 1))
        return outs_cls, outs_reg


@dataclass(frozen=True)
class RPNTrainConfig:
    pos_iou_thr: float = 0.7
    neg_iou_thr: float = 0.3
    min_pos_iou: float = 0.3
    num_samples: int = 256
    pos_fraction: float = 0.5
    cls_weight: float = 1.0
    bbox_weight: float = 1.0
    pad_divisor: int = 32


def rpn_loss(ctx: AnchorContext, cls_flat, reg_flat, gt, img_shapes,
             pos_keys, neg_keys, coder: DeltaXYWHBBoxCoder,
             cfg: RPNTrainConfig = RPNTrainConfig(), num_base_anchors=3):
    """erd_tpu's ``rpn_loss`` on a batch.

    Args:
        cls_flat: (B, N) float32 objectness logits; reg_flat (B, N, 4)
            float32 deltas, anchors in ``ctx`` order.
        gt: GTInstances of (B, G, ...) tensors; img_shapes (B, 2) (H, W).
        pos_keys, neg_keys: (B, N) uniform draws of the sampler.
    Returns dict(loss_rpn_cls, loss_rpn_bbox) of 0-dim tensors.
    """
    anchors = ctx.device_anchors(cls_flat.device)
    pad_shape = torch.ceil(img_shapes / cfg.pad_divisor) * cfg.pad_divisor
    vf = valid_flags(ctx.featmap_sizes, ctx.strides, pad_shape)
    vf = vf.repeat_interleave(num_base_anchors, dim=-1)
    res = max_iou_assign(anchors, gt.bboxes, torch.zeros_like(gt.labels),
                         gt.mask, pos_iou_thr=cfg.pos_iou_thr,
                         neg_iou_thr=cfg.neg_iou_thr,
                         min_pos_iou=cfg.min_pos_iou, match_low_quality=True,
                         valid_flags=vf)
    neg_mask = ~res.pos_mask & (res.labels != -2) & vf
    sample = random_sample(res.pos_mask & vf, neg_mask, pos_keys, neg_keys,
                           num=cfg.num_samples,
                           pos_fraction=cfg.pos_fraction)
    sel_w = sample.valid.float()
    n_sampled = sel_w.sum(-1).clamp(min=1.0)
    bce = binary_cross_entropy_with_logits(
        torch.gather(cls_flat, 1, sample.idx), sample.is_pos.float())
    loss_cls = (bce * sel_w).sum(-1) / n_sampled
    pos_w = (sample.is_pos & sample.valid).float()
    target = coder.encode(anchors[sample.idx], take_rows(
        gt.bboxes, torch.gather(res.gt_idx, 1, sample.idx)))
    target = torch.nan_to_num(target, nan=0.0, posinf=0.0, neginf=0.0)
    l1 = l1_loss(take_rows(reg_flat, sample.idx), target,
                 reduction='none').sum(-1)
    loss_bbox = (l1 * pos_w).sum(-1) / n_sampled
    return dict(loss_rpn_cls=cfg.cls_weight * loss_cls.mean(),
                loss_rpn_bbox=cfg.bbox_weight * loss_bbox.mean())


@dataclass(frozen=True)
class ProposalConfig:
    nms_pre: int = 1000
    max_per_img: int = 1000
    iou_threshold: float = 0.7
    min_bbox_size: float = 0.0


def rpn_proposals(ctx: AnchorContext, cls_lvl, reg_lvl, img_shapes,
                  coder: DeltaXYWHBBoxCoder,
                  cfg: ProposalConfig = ProposalConfig()):
    """Per-image fixed-size proposals from float32 level outputs
    (cls (B, H, W, A), reg (B, H, W, 4A)) and (B, 2) image shapes.

    Returns (boxes (B, max_per_img, 4), scores (B, max_per_img), mask);
    empty slots are zero boxes with mask False.
    """
    b = cls_lvl[0].shape[0]
    anchors = ctx.device_anchors(cls_lvl[0].device)
    starts = np.concatenate([[0], np.cumsum(ctx.num_level_anchors)])
    boxes_all, scores_all, lvl_all = [], [], []
    for lvl, (cls, reg) in enumerate(zip(cls_lvl, reg_lvl)):
        n_l = ctx.num_level_anchors[lvl]
        scores = torch.sigmoid(cls.reshape(b, n_l))
        k = min(cfg.nms_pre, n_l)
        top_s, top_idx = topk_stable(scores, k)
        pri = anchors[int(starts[lvl]):int(starts[lvl + 1])][top_idx]
        deltas = take_rows(reg.reshape(b, n_l, 4), top_idx)
        boxes_all.append(coder.decode(pri, deltas, max_shape=img_shapes))
        scores_all.append(top_s)
        lvl_all.append(torch.full((b, k), lvl, dtype=torch.int64,
                                  device=top_s.device))
    boxes = torch.cat(boxes_all, dim=1)
    scores = torch.cat(scores_all, dim=1)
    lvls = torch.cat(lvl_all, dim=1)
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    valid = (w > cfg.min_bbox_size) & (h > cfg.min_bbox_size)
    ob, os_, _, om = nms_select(boxes, scores, lvls, cfg.iou_threshold,
                                cfg.max_per_img, valid_mask=valid)
    return ob, os_, om
