"""GFL dense head: network module, training targets and loss, and predict
post-processing; the counterpart of erd_tpu/models/heads/gfl_head.py.

The network computes NCHW and returns NHWC level maps, erd_tpu's layout:
``gfl_predict`` flattens each level as (B, H*W, C), so anchor index
``h * W + w`` pairs with the row-major anchors of ``AnchorGenerator``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops import (cap_candidates, filter_scores_and_topk, integral_decode,
                    nms_select_cfg)
from ...ops.gfl_loss import fused_gfl_loss
from ...structures import DetResults, GTInstances, ImageMeta, scale_boxes
from ...task import (AnchorGenerator, atss_assign, featmap_sizes_for,
                     valid_flags)
from ..layers import Conv2d, ConvModule, Scale


class GFLHeadNet(nn.Module):
    """Shared cls/reg conv towers, gfl_cls / gfl_reg, per-level Scale.

    Names follow mmdet: ``cls_convs.{i}.{conv,gn}``, ``reg_convs.{i}...``,
    ``gfl_cls``, ``gfl_reg``, ``scales.{i}.scale``. Returns per-level
    (cls_scores in the compute dtype, bbox_preds in float32), NHWC.
    """

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 reg_max: int = 16, num_levels: int = 5):
        super().__init__()
        self.num_levels = num_levels
        self.cls_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels,
                       feat_channels, 3)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels,
                       feat_channels, 3)
            for i in range(stacked_convs))
        self.gfl_cls = Conv2d(feat_channels, num_classes, 3)
        self.gfl_reg = Conv2d(feat_channels, 4 * (reg_max + 1), 3)
        self.scales = nn.ModuleList(Scale(1.0) for _ in range(num_levels))

    def forward(self, feats: Sequence[torch.Tensor]):
        assert len(feats) == self.num_levels
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            cls = self.gfl_cls(cls_feat)
            reg = self.scales[lvl](self.gfl_reg(reg_feat)).float()
            cls_scores.append(cls.permute(0, 2, 3, 1))
            bbox_preds.append(reg.permute(0, 2, 3, 1))
        return cls_scores, bbox_preds


@dataclass(frozen=True)
class AnchorContext:
    """Everything static about the anchor grid of one canvas shape."""
    image_shape: Tuple[int, int]
    featmap_sizes: Tuple[Tuple[int, int], ...]
    num_level_anchors: Tuple[int, ...]
    strides: Tuple[int, ...]
    anchors: np.ndarray            # (N, 4)
    stride_per_anchor: np.ndarray  # (N,)
    _device_cache: Dict = field(default_factory=dict, compare=False,
                                repr=False)

    @staticmethod
    def build(image_shape, generator: AnchorGenerator = AnchorGenerator()):
        sizes = featmap_sizes_for(image_shape, generator.strides)
        anchors = generator.flat_anchors(sizes)
        nla = generator.num_level_anchors(sizes)
        spa = np.concatenate([np.full(n, s, np.float32)
                              for n, s in zip(nla, generator.strides)])
        return AnchorContext(
            image_shape=tuple(image_shape), featmap_sizes=tuple(sizes),
            num_level_anchors=tuple(nla), strides=tuple(generator.strides),
            anchors=anchors, stride_per_anchor=spa)

    @property
    def num_anchors(self):
        return int(self.anchors.shape[0])

    def device_anchors(self, device):
        """(N, 4) float32 anchors on ``device``, uploaded once per device."""
        key = ('anchors', str(device))
        if key not in self._device_cache:
            self._device_cache[key] = torch.as_tensor(self.anchors,
                                                      device=device)
        return self._device_cache[key]

    def device_tensors(self, device):
        """(centers (N, 2), stride_per_anchor (N,)) float32 on ``device``,
        uploaded once per device."""
        key = str(device)
        if key not in self._device_cache:
            a = self.anchors
            centers = (a[:, :2] + a[:, 2:]) / np.float32(2.0)
            self._device_cache[key] = (
                torch.as_tensor(centers, device=device),
                torch.as_tensor(self.stride_per_anchor, device=device))
        return self._device_cache[key]


@dataclass(frozen=True)
class GFLTrainConfig:
    assigner_topk: int = 9
    qfl_weight: float = 1.0
    qfl_beta: float = 2.0
    bbox_weight: float = 2.0
    dfl_weight: float = 0.25
    pad_divisor: int = 32


@dataclass(frozen=True)
class GFLTestConfig:
    score_thr: float = 0.05
    nms_pre: int = 1000
    iou_threshold: float = 0.6
    max_per_img: int = 100
    min_bbox_size: float = 0.0
    # global cap on candidates entering NMS after the level concat
    pre_nms_total: int = 2000
    # 'nms' (greedy hard NMS) or 'soft_nms' (the soft-NMS scan; the
    # reference's test_cfg nms=dict(type='soft_nms', ...))
    nms_type: str = 'nms'
    soft_nms_method: str = 'linear'  # 'linear' | 'gaussian'
    soft_nms_sigma: float = 0.5
    soft_nms_min_score: float = 1e-3


def flatten_levels(level_maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B, H, W, C)] -> (B, sum HW, C), contiguous."""
    b, c = level_maps[0].shape[0], level_maps[0].shape[-1]
    return torch.cat([m.reshape(b, -1, c) for m in level_maps], dim=1)


@dataclass
class GFLTargets:
    """Per-anchor training targets of a batch."""
    labels: torch.Tensor         # (B, N) int64, num_classes = background
    label_weights: torch.Tensor  # (B, N) float32
    bbox_targets: torch.Tensor   # (B, N, 4) float32
    pos_mask: torch.Tensor       # (B, N) bool
    num_pos: torch.Tensor        # () float32, positives of the batch


def gfl_targets(ctx: AnchorContext, gt: GTInstances, img_shapes, num_classes,
                topk=9, pad_divisor=32) -> GFLTargets:
    """ATSS targets for a padded batch.

    gt: GTInstances of (B, G, ...) tensors; img_shapes: (B, 2) float32
    (H, W) of each image inside the canvas. Anchors outside the image's
    pad-to-divisor shape are invalid: never positive, label weight 0.
    """
    device = gt.bboxes.device
    pad_shape = torch.ceil(img_shapes / pad_divisor) * pad_divisor
    vf = valid_flags(ctx.featmap_sizes, ctx.strides, pad_shape)
    res = atss_assign(ctx.device_anchors(device), ctx.num_level_anchors,
                      gt.bboxes, gt.labels, gt.mask, vf, topk=topk)
    pos = res.pos_mask
    labels = torch.where(pos, res.labels,
                         torch.full_like(res.labels, num_classes))
    boxes = torch.gather(gt.bboxes, 1, res.gt_idx[..., None].expand(
        -1, -1, 4))
    bbox_targets = torch.where(pos[..., None], boxes,
                               torch.zeros_like(boxes))
    return GFLTargets(labels=labels, label_weights=vf.float(),
                      bbox_targets=bbox_targets, pos_mask=pos,
                      num_pos=pos.sum().float())


def gfl_loss(ctx: AnchorContext, cls_scores, bbox_preds, targets: GFLTargets,
             cfg: GFLTrainConfig = GFLTrainConfig(), reg_max=16):
    """GFL loss over the concatenated anchor axis.

    cls_scores (B, N, C) float32 logits (may be a class slice of a wider
    map); bbox_preds (B, N, 4*(reg_max+1)) float32. Returns dict(loss_cls,
    loss_bbox, loss_dfl) through the fused loss (CUDA kernels on the card,
    the plain version on the CPU).
    """
    centers, strides = ctx.device_tensors(cls_scores.device)
    loss_cls, loss_bbox, loss_dfl = fused_gfl_loss(
        cls_scores, bbox_preds, targets.labels, targets.label_weights,
        targets.bbox_targets, targets.pos_mask, targets.num_pos, centers,
        strides, qfl_weight=cfg.qfl_weight, qfl_beta=cfg.qfl_beta,
        bbox_weight=cfg.bbox_weight, dfl_weight=cfg.dfl_weight,
        reg_max=reg_max)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, loss_dfl=loss_dfl)


def gfl_predict(ctx: AnchorContext, cls_scores_lvl, bbox_preds_lvl,
                meta: ImageMeta, cfg: GFLTestConfig = GFLTestConfig(),
                reg_max=16, rescale=True) -> DetResults:
    """Batched inference post-processing.

    Per level: sigmoid, threshold and top-k over (anchor, class) pairs;
    then one decode of every level's candidate rows, read in the level
    maps where they lie (integral x stride, centre +/- distance, clip to
    img_shape); concat, cap to
    ``pre_nms_total``, rescale, drop empty boxes, class-aware NMS, top
    ``max_per_img``. ``meta`` holds (B, 2) float32 tensors.
    """
    b = cls_scores_lvl[0].shape[0]
    device = cls_scores_lvl[0].device
    centers, strides = ctx.device_tensors(device)
    starts = np.concatenate([[0], np.cumsum(ctx.num_level_anchors)])
    rows, scores, labels, valid = [], [], [], []
    for lvl, cls in enumerate(cls_scores_lvl):
        n_l = ctx.num_level_anchors[lvl]
        probs = torch.sigmoid(cls.reshape(b, n_l, cls.shape[-1]))
        k = min(cfg.nms_pre, n_l * probs.shape[-1]) if cfg.nms_pre > 0 \
            else n_l * probs.shape[-1]
        top_s, top_lab, top_idx, mask = filter_scores_and_topk(
            probs, cfg.score_thr, k)
        rows.append(top_idx + int(starts[lvl]))
        scores.append(top_s)
        labels.append(top_lab)
        valid.append(mask)
    boxes = integral_decode(list(bbox_preds_lvl), torch.cat(rows, dim=1),
                            centers, strides, meta.img_shape.contiguous(),
                            reg_max)
    scores, valid, boxes, labels = cap_candidates(
        torch.cat(scores, dim=1), torch.cat(valid, dim=1),
        cfg.pre_nms_total, boxes, torch.cat(labels, dim=1))
    if rescale:
        boxes = scale_boxes(boxes, 1.0 / meta.scale_factor)
    if cfg.min_bbox_size >= 0:
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        valid = valid & (w > cfg.min_bbox_size) & (h > cfg.min_bbox_size)
    out_boxes, out_scores, out_labels, out_mask = nms_select_cfg(
        boxes, scores, labels, cfg, valid_mask=valid)
    return DetResults(bboxes=out_boxes, scores=out_scores, labels=out_labels,
                      mask=out_mask, num_candidates=valid.sum(dim=-1))
