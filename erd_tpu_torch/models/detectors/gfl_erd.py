"""ERD incremental detector: frozen teacher + student, supervised loss on the
new classes and ERS-selected distillation on the old ones; the counterpart
of erd_tpu/models/detectors/gfl_erd.py.

Class-channel layout: the teacher owns channels [0, ori_num_classes); the
new task's labels 0..K-1 supervise the student's channels
[ori_num_classes, num_classes) through a slice of its class map.

The distillation (``erd_distill_losses``) runs three kernels in order:
``ers_select`` (ERS cls mask and capped reg candidates), ``integral_decode``
(teacher boxes of the candidates, unit stride, no clip) with the NMS kernel
behind ``batched_nms_mask``, and ``fused_erd_distill`` (L2 + KD-KL, with
its backward).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ...ops import batched_nms_mask, integral_decode
from ...ops.erd_distill import fused_erd_distill
from ...ops.ers_select import ers_cls_mask_dense, ers_select
from ...ops.misc import take_rows
from ...structures.boxes import bbox_center
from ...utils import resolve_device
from ..heads.gfl_head import flatten_levels, gfl_loss, gfl_targets
from ..weight_import import widen_cls_head
from .single_stage import GFLDetector, GFLNet

__all__ = ['ERDConfig', 'ERDDetector', 'ers_cls_mask_dense',
           'erd_distill_losses']


@dataclass
class ERDConfig:
    ori_num_classes: int = 40
    dist_loss_weight: float = 1.0
    ld_weight: float = 0.25
    ld_T: float = 10.0
    distill_nms_iou: float = 0.005
    # reg-branch candidate cap; 0 = N // 5 + 1, which one-sided Chebyshev
    # shows can never truncate a mu + 2 sigma selection
    ers_reg_cap: int = 0
    # NMS over only the first K candidates when every image's selection
    # count fits in K (the selected rows are a prefix of the list); 0 = off
    ers_nms_fast_k: int = 1024
    num_devices: int = 1  # data-parallel width, for DDP-equivalent scaling


def _kept_dense(centers, unit, t_cls, t_reg, ri, rm, iou, reg_max):
    """NMS-dedupe the ERS-reg candidates of each image; (B, N) bool."""
    boxes = integral_decode(t_reg, ri, centers, unit, None, reg_max)
    conf_all = torch.sigmoid(take_rows(t_cls, ri))
    conf, ids = conf_all.amax(dim=-1), conf_all.argmax(dim=-1)
    keep = batched_nms_mask(boxes, conf, ids, iou, valid_mask=rm)
    kept = torch.zeros(t_cls.shape[:2], dtype=torch.bool, device=t_cls.device)
    return kept.scatter(1, ri, keep & rm)


def erd_distill_losses(anchors, s_cls, s_reg, t_cls, t_reg, cfg: ERDConfig,
                       reg_max=16):
    """ERD distillation terms of a batch (head :142-223 of the reference).

    Args:
        anchors: (N, 4) float32 anchors of the canvas.
        s_cls: (B, N, num_classes) float32 student class logits.
        s_reg: (B, N, 4*(reg_max+1)) float32 student distribution logits.
        t_cls: (B, N, ori_num_classes) float32 teacher class logits.
        t_reg: (B, N, 4*(reg_max+1)) float32 teacher distribution logits.
    Returns (loss_dist_cls, loss_dist_bbox), each (B,) per-image sums; the
    caller applies dist_loss_weight and the 1/num_devices scaling.

    The fast-path branch reads the largest selection count on the host,
    once per call; ``erd_distill_losses.last_branch`` keeps that count
    (None where the branch is off) and the candidates per image that the
    NMS ran on.
    """
    n = t_cls.shape[1]
    centers = bbox_center(anchors)  # full-canvas frame, unit stride
    unit = torch.ones((n,), dtype=torch.float32, device=anchors.device)
    cap = cfg.ers_reg_cap if cfg.ers_reg_cap > 0 else n // 5 + 1
    cls_mask, reg_idx, reg_mask, count = ers_select(t_cls, t_reg,
                                                    min(cap, n))
    cap = reg_idx.shape[1]
    fast_k = min(cfg.ers_nms_fast_k, cap) if cfg.ers_nms_fast_k > 0 else 0
    selected = int(count.max()) if 0 < fast_k < cap else None
    if selected is not None and selected <= fast_k:
        reg_idx = reg_idx[:, :fast_k].contiguous()
        reg_mask = reg_mask[:, :fast_k].contiguous()
    erd_distill_losses.last_branch = dict(selected=selected,
                                          nms_k=reg_idx.shape[1])
    kept = _kept_dense(centers, unit, t_cls, t_reg, reg_idx, reg_mask,
                       cfg.distill_nms_iou, reg_max)
    return fused_erd_distill(s_cls, s_reg, t_cls, t_reg, cls_mask, kept,
                             T=cfg.ld_T, ld_weight=cfg.ld_weight,
                             reg_max=reg_max)


erd_distill_losses.last_branch = None


@dataclass
class ERDDetector(GFLDetector):
    """Student detector; ``teacher`` is the frozen stage-1 detector's
    configuration (``ori_num_classes`` outputs, same architecture)."""
    erd: ERDConfig = field(default_factory=ERDConfig)

    def __post_init__(self):
        super().__post_init__()
        self.teacher = GFLDetector(
            num_classes=self.erd.ori_num_classes, depth=self.depth,
            reg_max=self.reg_max, compute_dtype=self.compute_dtype,
            frozen_stages=self.frozen_stages,
            preprocessor=self.preprocessor,
            anchor_generator=self.anchor_generator,
            train_cfg=self.train_cfg, test_cfg=self.test_cfg)

    def init_teacher(self, seed: int = 0, device=None) -> GFLNet:
        """A seeded random teacher network, every parameter frozen."""
        return self.teacher.init(seed, device).requires_grad_(False)

    def init_student_from_teacher(self, seed: int, teacher: GFLNet,
                                  device=None) -> GFLNet:
        """A fresh student (``init(seed)``) whose parameters all equal the
        teacher's, except the new-class channels of ``gfl_cls``; on
        ``device`` (``cuda`` unless the caller names one)."""
        device = resolve_device(device)
        student = self.init(seed, device='cpu')
        student.load_state_dict(widen_cls_head(
            teacher.state_dict(), student.state_dict(),
            self.erd.ori_num_classes))
        return student.to(device)

    def loss(self, net: GFLNet, batch, teacher: GFLNet = None):
        """Supervised new-class losses plus the distillation terms.

        Returns dict(loss_cls, loss_bbox, loss_dfl, loss_dist_cls,
        loss_dist_bbox) of 0-dim tensors; gradients reach ``net`` only.
        """
        if teacher is None:
            raise ValueError('the ERD loss needs the teacher network')
        cfg = self.erd
        images = batch['images']
        ctx = self.anchor_context(images.shape[1:3])
        ori_c = cfg.ori_num_classes
        new_c = self.num_classes - ori_c

        t_cls_lvl, t_reg_lvl = self.teacher.forward_raw(teacher, images)
        t_cls = flatten_levels(t_cls_lvl).float()
        t_reg = flatten_levels(t_reg_lvl).float()
        s_cls_lvl, s_reg_lvl = self.forward_train(net, images)
        s_cls = flatten_levels(s_cls_lvl).float()
        s_reg = flatten_levels(s_reg_lvl).float()

        targets = gfl_targets(ctx, batch['gt'], batch['meta'].img_shape,
                              new_c, topk=self.train_cfg.assigner_topk,
                              pad_divisor=self.train_cfg.pad_divisor)
        losses = gfl_loss(ctx, s_cls[..., ori_c:], s_reg, targets,
                          self.train_cfg, reg_max=self.reg_max)
        l_cls_i, l_reg_i = erd_distill_losses(
            ctx.device_anchors(images.device), s_cls, s_reg, t_cls, t_reg,
            cfg, reg_max=self.reg_max)
        # DDP-equivalent scaling of the per-image sums
        scale = cfg.dist_loss_weight / cfg.num_devices
        losses['loss_dist_cls'] = scale * l_cls_i.sum()
        losses['loss_dist_bbox'] = scale * l_reg_i.sum()
        return losses
