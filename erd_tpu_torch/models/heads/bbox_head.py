"""R-CNN bbox head (Shared2FC) and its predict post-processing; the
counterpart of erd_tpu/models/heads/bbox_head.py (serving).

flatten (C, 7, 7) -> fc1024 -> fc1024 -> {``fc_cls`` over C + 1 classes,
background last; ``fc_reg`` class-specific 4C deltas, stds (0.1, 0.1, 0.2,
0.2)}. mmdet flattens the RoI features channel-major, erd_tpu (7, 7, C);
``weight_import.params_from_jax`` permutes ``shared_fcs.0``'s input rows,
so the port loads mmdet checkpoints by name. Training (MaxIoU assignment,
random sampling, the CE + L1 loss) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import nms_select_cfg
from ...ops.misc import NEG_INF, take_rows, topk_stable
from ...structures import DetResults, scale_boxes
from ...task import DeltaXYWHBBoxCoder
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
