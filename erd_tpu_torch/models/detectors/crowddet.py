"""CrowdDet serving and training; the counterpart of
erd_tpu/models/detectors/crowddet.py.

Faster R-CNN R50-FPN up to the RoI features (the plain FPN, whatever the
config's neck, as erd_tpu's ``CrowdDetNet``), then a multiple-instance bbox
head: each RoI predicts K_INST = 2 instances, each with its own (C+1)-way
classifier and 4 class-agnostic deltas off a shared 2FC trunk. ``predict``
flattens both instances of every proposal, tags each with its proposal id
and runs set-NMS (``ops.set_nms_mask``, the NMS kernel with its group
test): the two instances of one proposal never suppress each other.
``loss`` is Faster R-CNN's RPN loss and RoI sampling, then the EMD loss:
the lesser of the two pairings of an RoI's two instances with its two
best-overlapping gts.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...losses import cross_entropy_int, smooth_l1_loss
from ...ops import cap_candidates, set_nms_mask
from ...ops.misc import NEG_INF, take_rows, topk_stable
from ...structures import DetResults, bbox_overlaps, scale_boxes
from ..heads.bbox_head import RoISamples, softmax
from ..layers import Linear
from .faster_rcnn import FasterRCNNDetector, FasterRCNNNet

K_INST = 2


class MultiInstanceBBoxHead(nn.Module):
    """mmdet names ``shared_fcs.{0,1}``, ``fc_cls.{k}`` and ``fc_reg.{k}``
    for the K_INST instances. Weights rounded to ``param_dtype`` and
    products in float32 on float32 RoI features, as ``Shared2FCBBoxHead``
    (whose HWC -> CHW permutation of ``shared_fcs.0``'s rows
    ``params_from_jax`` applies here too)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 roi_size: int = 7, fc_dim: int = 1024,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            Linear(in_channels * roi_size * roi_size, fc_dim, param_dtype),
            Linear(fc_dim, fc_dim, param_dtype)])
        self.fc_cls = nn.ModuleList(
            Linear(fc_dim, num_classes + 1, param_dtype)
            for _ in range(K_INST))
        self.fc_reg = nn.ModuleList(Linear(fc_dim, 4, param_dtype)
                                    for _ in range(K_INST))

    def forward(self, roi_feats):
        """(N, C, 7, 7) -> (cls (N, K_INST, C+1), reg (N, K_INST, 4))."""
        x = roi_feats.flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return (torch.stack([fc(x) for fc in self.fc_cls], 1),
                torch.stack([fc(x) for fc in self.fc_reg], 1))


class CrowdDetNet(FasterRCNNNet):
    """Faster R-CNN's backbone, FPN and RPN; roi_head.bbox_head is the
    multiple-instance head."""

    def __init__(self, num_classes: int, depth: int = 50,
                 frozen_stages: int = -1,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, depth=depth,
                         frozen_stages=frozen_stages,
                         param_dtype=param_dtype,
                         bbox_head=MultiInstanceBBoxHead)

    def init_head(self, normal):
        head = self.roi_head.bbox_head
        for fc in head.fc_cls:
            normal(fc.weight, 0.01)
        for fc in head.fc_reg:
            normal(fc.weight, 0.001)


@dataclass
class CrowdDetDetector(FasterRCNNDetector):
    """Config + functions of CrowdDet serving (erd_tpu's CrowdDetDetector:
    Faster R-CNN's RPN and test config, the plain FPN)."""

    def build_net(self) -> CrowdDetNet:
        return CrowdDetNet(self.num_classes, depth=self.depth,
                           frozen_stages=self.frozen_stages,
                           param_dtype=self.compute_dtype)

    def head_outputs(self, net: CrowdDetNet, roi_feats):
        """The head on (B, R, C, 7, 7) features -> float32 (cls (B, R,
        K_INST, C+1), reg (B, R, K_INST, 4)), recording the autograd
        graph."""
        b, r = roi_feats.shape[:2]
        cls, reg = net.roi_head.bbox_head(roi_feats.flatten(0, 1))
        return (cls.float().reshape(b, r, K_INST, -1),
                reg.float().reshape(b, r, K_INST, 4))

    def postprocess(self, cls_logits, reg_preds, rois, roi_mask, meta,
                    rescale=True) -> DetResults:
        """erd_tpu's CrowdDet predict after the head, per image: softmax;
        both instances decoded against their RoI and clipped; the best
        foreground score and its label; group = proposal id; the
        ``score_thr`` mask on valid RoIs; the top ``pre_nms_total``; rescale;
        set-NMS; the stable top ``max_per_img`` of the kept."""
        cfg, c = self.test_cfg, self.num_classes
        b, p = rois.shape[:2]
        probs = softmax(cls_logits)
        boxes = self.rcnn_coder.decode(rois[:, :, None, :], reg_preds,
                                       max_shape=meta.img_shape)
        best, labels = probs[..., :c].max(-1)  # first maximum on ties
        group = torch.arange(p, device=rois.device)[:, None].expand(p, K_INST)
        flat_s = best.reshape(b, p * K_INST)
        valid = roi_mask.repeat_interleave(K_INST, dim=-1) & \
            (flat_s > cfg.score_thr)
        fs, vmask, fb, fl, fg = cap_candidates(
            flat_s, valid, cfg.pre_nms_total, boxes.reshape(b, -1, 4),
            labels.reshape(b, -1), group.reshape(1, -1).expand(b, -1))
        if rescale:
            fb = scale_boxes(fb, 1.0 / meta.scale_factor)
        keep = set_nms_mask(fb, torch.where(vmask, fs,
                                            torch.full_like(fs, NEG_INF)),
                            fg, cfg.iou_threshold, valid_mask=vmask)
        top, idx = topk_stable(torch.where(keep, fs,
                                           torch.full_like(fs, NEG_INF)),
                               min(cfg.max_per_img, fs.shape[-1]))
        ok = top > NEG_INF
        return DetResults(bboxes=take_rows(fb, idx),
                          scores=torch.where(ok, top, torch.zeros_like(top)),
                          labels=take_rows(fl, idx), mask=ok,
                          num_candidates=vmask.sum(dim=-1))

    def rcnn_losses(self, net, feats, samples: RoISamples, gt, draws=None):
        """erd_tpu's EMD loss: dict(loss_emd), the mean over the valid
        samples of min(loss of pairing (0 -> gt 0, 1 -> gt 1), loss of
        pairing (0 -> gt 1, 1 -> gt 0)). A slot whose gt overlaps its RoI
        by less than 0.5 classifies background and regresses nothing."""
        cls2, reg2 = self.head_outputs(net, self.roi_feats(feats,
                                                           samples.rois))
        b, s = samples.rois.shape[:2]
        iou = bbox_overlaps(samples.rois, gt.bboxes)  # (B, S, G)
        iou = torch.where(gt.mask[:, None, :], iou,
                          torch.full_like(iou, -1.0))
        iou2, gti2 = topk_stable(iou, min(K_INST, iou.shape[-1]))
        slot_boxes = take_rows(gt.bboxes, gti2.flatten(1)).view(b, s, -1, 4)
        slot_labels = torch.gather(gt.labels.long(), 1,
                                   gti2.flatten(1)).view(b, s, -1)
        slot_on = iou2 >= 0.5

        def inst_loss(k, slot):
            lab = torch.where(slot_on[..., slot], slot_labels[..., slot],
                              torch.full_like(slot_labels[..., slot],
                                              self.num_classes))
            ce = cross_entropy_int(cls2[:, :, k], lab)
            deltas = self.rcnn_coder.encode(samples.rois,
                                            slot_boxes[:, :, slot])
            deltas = torch.nan_to_num(deltas, nan=0.0, posinf=0.0,
                                      neginf=0.0)
            sl1 = smooth_l1_loss(reg2[:, :, k], deltas, beta=1.0,
                                 reduction='none').sum(-1)
            return ce + torch.where(slot_on[..., slot], sl1,
                                    torch.zeros_like(sl1))

        loss_a = inst_loss(0, 0) + inst_loss(1, 1)
        loss_b = inst_loss(0, 1) + inst_loss(1, 0)
        emd = torch.minimum(loss_a, loss_b)
        valid = samples.valid.float()
        return dict(loss_emd=(emd * valid).sum() / valid.sum().clamp(
            min=1.0))
