"""VarifocalNet (VFNet) head: IoU-aware classification with star-shaped
deformable refinement; the counterpart of erd_tpu/models/heads/vfnet_head.py
(the network, the point grid and its ATSS anchors, decoding,
``vfnet_loss`` and ``vfnet_predict``).

Per level: initial distances exp(scale(conv)) * reg_denom; the star offsets
put the 9 points of a 3x3 deformable convolution on the predicted box's
corners and edge midpoints; the refined distances are exp(scale_refine(
conv(relu(dconv)))) times the initial ones, and the classification reads
its own deformable convolution at the same offsets. The network computes
NCHW and returns NHWC level maps, erd_tpu's layout.

bf16 numerics of erd_tpu: the feature maps and the deformable weights are in
the compute dtype, the distances and offsets float32; each ``Scale`` acts on
a float32 map with its parameter rounded to the compute dtype first
(``cast_compute_params``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...losses import giou_loss, varifocal_loss
from ...ops import cap_candidates, filter_scores_and_topk, nms_select
from ...ops.deform_conv import DeformConv2d
from ...ops.misc import take_rows
from ...structures import DetResults, distance2bbox, scale_boxes
from ...structures.boxes import bbox_overlaps
from ...task.atss import atss_assign
from ..layers import Conv2d, ConvModule, Scale
from .gfl_head import GFLTestConfig

STRIDES = (8, 16, 32, 64, 128)
REG_DENOMS = (64, 128, 256, 512, 1024)
# erd_tpu's VFNetHeadNet default: the share of the star offsets' gradient
# that reaches the box branch (``vfnet_reg``); the rest is detached
GRADIENT_MUL = 0.1
# ATSS of the loss: anchors are squares of OCTAVE_BASE_SCALE strides at
# each point, ATSS_TOPK candidates per level and gt
OCTAVE_BASE_SCALE, ATSS_TOPK = 8, 9

# 3x3 kernel-relative base grid, row-major (ky, kx) in {-1, 0, 1}, (y, x)
_BASE = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], indexing='ij'),
                 -1).reshape(9, 2).astype(np.float32)


def star_offsets(bbox_pred, stride):
    """(B, 4, H, W) float32 distances (image units) -> (B, 18, H, W)
    offsets of one deform group: the 9 points' (dy, dx) from the 3x3 base
    grid to the box's corners and edge midpoints, at feature scale."""
    bp = (1.0 - GRADIENT_MUL) * bbox_pred.detach() + GRADIENT_MUL * bbox_pred
    bp = bp / torch.full_like(bp, stride)
    x1, y1, x2, y2 = bp.unbind(1)
    zero = torch.zeros_like(x1)
    ys = torch.stack([-y1, -y1, -y1, zero, zero, zero, y2, y2, y2], 1)
    xs = torch.stack([-x1, zero, x2, -x1, zero, x2, -x1, zero, x2], 1)
    base = torch.as_tensor(_BASE, device=bp.device)[:, :, None, None]
    off = torch.stack([ys - base[:, 0], xs - base[:, 1]], 2)  # (B, 9, 2, ..)
    return off.reshape(bp.shape[0], 18, *bp.shape[2:])


def _scaled(scale: Scale, y, dtype):
    """erd_tpu's Scale on a float32 map: the parameter rounded to the
    compute dtype, then widened."""
    return y * scale.scale.to(dtype).float()


class VFNetHeadNet(nn.Module):
    """Names follow mmdet: ``cls_convs.{i}``, ``reg_convs.{i}`` and
    ``vfnet_reg_conv`` (``conv``, ``gn``), ``vfnet_reg``,
    ``vfnet_reg_refine_dconv``, ``vfnet_reg_refine``, ``vfnet_cls_dconv``,
    ``vfnet_cls``, ``scales.{i}.scale``, ``scales_refine.{i}.scale``.
    Returns per-level (cls_scores, bbox_inis, bbox_refines), float32 NHWC.
    """

    def __init__(self, num_classes: int, feat_channels: int = 256):
        super().__init__()
        c = feat_channels
        self.cls_convs = nn.ModuleList(ConvModule(c, c, 3) for _ in range(3))
        self.reg_convs = nn.ModuleList(ConvModule(c, c, 3) for _ in range(3))
        self.vfnet_reg_conv = ConvModule(c, c, 3)
        self.vfnet_reg = Conv2d(c, 4, 3)
        self.vfnet_reg_refine_dconv = DeformConv2d(c, c)
        self.vfnet_reg_refine = Conv2d(c, 4, 3)
        self.vfnet_cls_dconv = DeformConv2d(c, c)
        self.vfnet_cls = Conv2d(c, num_classes, 3)
        self.scales = nn.ModuleList(Scale(1.0) for _ in STRIDES)
        self.scales_refine = nn.ModuleList(Scale(1.0) for _ in STRIDES)

    def forward(self, feats: Sequence[torch.Tensor]):
        assert len(feats) == len(STRIDES)
        cls_scores, bbox_inis, bbox_refines = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            reg_init = self.vfnet_reg(self.vfnet_reg_conv(reg_feat)).float()
            bbox_pred = torch.exp(_scaled(self.scales[lvl], reg_init,
                                          x.dtype)) * REG_DENOMS[lvl]
            offsets = star_offsets(bbox_pred, STRIDES[lvl])
            reg_ref = F.relu(self.vfnet_reg_refine_dconv(reg_feat, offsets))
            refine = torch.exp(_scaled(
                self.scales_refine[lvl],
                self.vfnet_reg_refine(reg_ref).float(), x.dtype))
            bbox_refine = refine * bbox_pred.detach()
            cls_feat = F.relu(self.vfnet_cls_dconv(cls_feat, offsets))
            cls = self.vfnet_cls(cls_feat).float()
            cls_scores.append(cls.permute(0, 2, 3, 1))
            bbox_inis.append(bbox_pred.permute(0, 2, 3, 1))
            bbox_refines.append(bbox_refine.permute(0, 2, 3, 1))
        return cls_scores, bbox_inis, bbox_refines


@dataclass(frozen=True)
class VFNetContext:
    """The point grid of one canvas shape (erd_tpu's VFNetContext): the
    points, their strides and the ATSS anchors of the loss, squares of
    OCTAVE_BASE_SCALE strides centred on the points."""
    image_shape: Tuple[int, int]
    num_level_points: Tuple[int, ...]
    points: np.ndarray   # (N, 2)
    strides: np.ndarray  # (N,)
    anchors: np.ndarray  # (N, 4)
    _device_cache: Dict = field(default_factory=dict, compare=False,
                                repr=False)

    @staticmethod
    def build(image_shape):
        pts, strides, anchors, counts = [], [], [], []
        for s in STRIDES:
            h = math.ceil(image_shape[0] / s)
            w = math.ceil(image_shape[1] / s)
            # anchor_center_offset 0.0 for VFNet's fcos grid
            xs = np.arange(w, dtype=np.float32) * s + s / 2.0
            ys = np.arange(h, dtype=np.float32) * s + s / 2.0
            gx, gy = np.meshgrid(xs, ys)
            p = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
            pts.append(p)
            strides.append(np.full(len(p), s, np.float32))
            half = OCTAVE_BASE_SCALE * s / 2.0
            anchors.append(np.concatenate([p - half, p + half], -1))
            counts.append(len(p))
        return VFNetContext(image_shape=tuple(image_shape),
                            num_level_points=tuple(counts),
                            points=np.concatenate(pts),
                            strides=np.concatenate(strides),
                            anchors=np.concatenate(anchors))

    def _on(self, name, device):
        key = (name, str(device))
        if key not in self._device_cache:
            self._device_cache[key] = torch.as_tensor(getattr(self, name),
                                                      device=device)
        return self._device_cache[key]

    def device_points(self, device):
        """(N, 2) float32 points on ``device``, uploaded once per device."""
        return self._on('points', device)

    def device_anchors(self, device):
        """(N, 4) float32 ATSS anchors on ``device``, uploaded once."""
        return self._on('anchors', device)


def decode_levels(ctx: VFNetContext, dist_lvl):
    """Per-level (B, H, W, 4) ltrb distances -> xyxy boxes at the grid
    points."""
    points = ctx.device_points(dist_lvl[0].device)
    out, start = [], 0
    for lvl, d in enumerate(dist_lvl):
        _, h, w, _ = d.shape
        n_l = ctx.num_level_points[lvl]
        pts = points[start:start + n_l].reshape(h, w, 2)
        out.append(distance2bbox(pts[None], d))
        start += n_l
    return out


def vfnet_loss(ctx: VFNetContext, cls_scores, bbox_ini, bbox_refine, gt,
               num_classes: int):
    """VFNet's losses of a batch (erd_tpu's ``vfnet_loss``).

    Args:
        cls_scores: (B, N, C) logits; bbox_ini, bbox_refine: (B, N, 4)
            decoded xyxy boxes of the initial and the refined distances,
            all float32 (or float64).
        gt: GTInstances of (B, G) padded boxes, labels and masks.
    ATSS assigns the anchors (every anchor valid) to the gt; each positive
    point's initial and refined box take a GIoU loss weighted by their own
    detached IoU with the target (clipped at 0), over the batch's summed
    IoU (weights 1.5 and 2.0); the classification is the varifocal loss
    against the one-hot target scaled by the refined box's IoU, over
    max(num_pos, 1). Returns dict(loss_cls, loss_bbox, loss_bbox_rf).
    """
    b, n = cls_scores.shape[:2]
    dev = cls_scores.device
    res = atss_assign(ctx.device_anchors(dev), ctx.num_level_points,
                      gt.bboxes, gt.labels, gt.mask,
                      torch.ones((b, n), dtype=torch.bool, device=dev),
                      topk=ATSS_TOPK)
    pos = res.pos_mask
    tgt = torch.gather(gt.bboxes, 1, res.gt_idx[..., None].expand(b, n, 4))
    zero = torch.zeros((), dtype=bbox_ini.dtype, device=dev)

    def iou(boxes):
        ov = bbox_overlaps(boxes.detach(), tgt, is_aligned=True)
        return torch.where(pos, ov, zero).clamp(min=0.0)
    iou_ini, iou_rf = iou(bbox_ini), iou(bbox_refine)
    l_ini = (giou_loss(bbox_ini, tgt, reduction='none') * iou_ini).sum()
    l_rf = (giou_loss(bbox_refine, tgt, reduction='none') * iou_rf).sum()
    labels = torch.where(pos, res.labels, torch.zeros_like(res.labels))
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(iou_rf.dtype)
    target = onehot * iou_rf[..., None] * pos[..., None]
    l_cls = varifocal_loss(cls_scores, target, reduction='sum')
    num_pos = pos.sum().to(cls_scores.dtype).clamp(min=1.0)
    return {'loss_cls': l_cls / num_pos,
            'loss_bbox': 1.5 * l_ini / iou_ini.sum().clamp(min=1.0),
            'loss_bbox_rf': 2.0 * l_rf / iou_rf.sum().clamp(min=1.0)}


def vfnet_predict(ctx: VFNetContext, cls_lvl, box_lvl, meta,
                  cfg: GFLTestConfig, num_classes: int,
                  rescale=True) -> DetResults:
    """Batched post-processing of float32 (B, H, W, C) logits and decoded
    (B, H, W, 4) xyxy boxes: per level sigmoid, threshold and top-k over
    (point, class) pairs, boxes clipped to the image; concat, cap to
    ``pre_nms_total``, rescale, class-aware hard NMS, top ``max_per_img``.
    """
    b = cls_lvl[0].shape[0]
    h, w = meta.img_shape[:, 0], meta.img_shape[:, 1]
    hi = torch.stack([w, h, w, h], -1)[:, None, :]
    boxes, scores, labels, valid = [], [], [], []
    for lvl, (cls, box) in enumerate(zip(cls_lvl, box_lvl)):
        n_l = ctx.num_level_points[lvl]
        probs = torch.sigmoid(cls.reshape(b, n_l, num_classes))
        k = min(cfg.nms_pre, n_l * num_classes) if cfg.nms_pre > 0 \
            else n_l * num_classes
        top_s, top_lab, top_idx, mask = filter_scores_and_topk(
            probs, cfg.score_thr, k)
        bx = take_rows(box.reshape(b, n_l, 4), top_idx)
        boxes.append(torch.minimum(bx.clamp(min=0), hi))
        scores.append(top_s)
        labels.append(top_lab)
        valid.append(mask)
    scores, valid, boxes, labels = cap_candidates(
        torch.cat(scores, 1), torch.cat(valid, 1), cfg.pre_nms_total,
        torch.cat(boxes, 1), torch.cat(labels, 1))
    if rescale:
        boxes = scale_boxes(boxes, 1.0 / meta.scale_factor)
    ob, os_, ol, om = nms_select(boxes, scores, labels, cfg.iou_threshold,
                                 cfg.max_per_img, valid_mask=valid)
    return DetResults(bboxes=ob, scores=os_, labels=ol, mask=om,
                      num_candidates=valid.sum(dim=-1))
