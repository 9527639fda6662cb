"""Faster R-CNN (R50-FPN) serving and training; the counterpart of
erd_tpu/models/detectors/faster_rcnn.py.

ResNet (frozen BN) -> FPN P2-P6 (``start_level=0``, P6 by a stride-2
subsample), or FPN_CARAFE (``neck=dict(type='FPN_CARAFE', ...)``) -> RPN ->
1000 padded proposals per image -> RoIAlign 7x7 on P2-P5 (kernel
``csrc/roi_align.cu``) -> Shared2FC bbox head -> per-class decode, top-2000
and hard or soft NMS. As in erd_tpu, the detector is configuration plus
functions and ``FasterRCNNNet`` holds the weights.

``loss``: the RPN loss; proposals (2000 per level before the NMS, 1000
kept) from the detached RPN outputs; the gt boxes joined to them, assigned
and sampled (512 RoIs an image); RoIAlign of the samples with gradients
into the FPN maps (the backward kernel of ``csrc/roi_align.cu``); the R-CNN
CE and L1. The samplers' uniform draws come from a ``torch.Generator``
seeded with the batch's ``img_id`` sum (erd_tpu folds the same sum into its
PRNG key; the streams differ), or from the caller.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...ops import CARAFEPack, multilevel_roi_align
from ...structures import DetResults
from ...task import DeltaXYWHBBoxCoder
from ...utils import resolve_device
from ..backbones.resnet import ResNet
from ..heads.bbox_head import (RCNNTrainConfig, RoISamples,
                               Shared2FCBBoxHead, rcnn_loss, rcnn_predict,
                               rcnn_sample)
from ..heads.gfl_head import AnchorContext, GFLTestConfig
from ..heads.rpn_head import (ProposalConfig, RPNHeadNet, RPNTrainConfig,
                              rpn_anchor_generator, rpn_loss, rpn_proposals)
from ..layers import Conv2d, Linear
from ..necks import FPN, FPNCARAFE
from ..preprocessor import Preprocessor

ROI_STRIDES = (4, 8, 16, 32)  # the levels RoIAlign samples: P2-P5


def build_neck(in_channels, neck: Optional[dict] = None) -> nn.Module:
    """The default FPN (P2-P6, max-pool P6), or an FPN_CARAFE spec."""
    if neck is None:
        return FPN(in_channels=in_channels, out_channels=256, num_outs=5,
                   start_level=0, add_extra_convs='')
    kw = dict(neck)
    if kw.pop('type', None) != 'FPN_CARAFE':
        raise NotImplementedError(f'neck {neck} is not ported yet')
    return FPNCARAFE(in_channels=in_channels, **kw)


class RoIHead(nn.Module):
    """Holds ``bbox_head`` under mmdet's ``roi_head.bbox_head`` names."""

    def __init__(self, num_classes: int, param_dtype: torch.dtype,
                 head=Shared2FCBBoxHead):
        super().__init__()
        self.bbox_head = head(num_classes, param_dtype=param_dtype)


class FasterRCNNNet(nn.Module):
    """backbone -> neck -> rpn_head, and roi_head.bbox_head; mmdet names.
    ``neck`` is None (FPN) or an FPN_CARAFE spec; ``bbox_head`` the head's
    class."""

    def __init__(self, num_classes: int, depth: int = 50,
                 frozen_stages: int = -1,
                 param_dtype: torch.dtype = torch.float32,
                 neck: Optional[dict] = None, bbox_head=Shared2FCBBoxHead):
        super().__init__()
        self.backbone = ResNet(depth, frozen_stages=frozen_stages)
        self.neck = build_neck(self.backbone.out_channels, neck)
        self.rpn_head = RPNHeadNet()
        self.roi_head = RoIHead(num_classes, param_dtype, bbox_head)

    def extract_feat(self, x):
        return self.neck(self.backbone(x))

    def forward(self, x):
        """erd_tpu's ``FasterRCNNNet.__call__``: RPN outputs and the bbox
        head on four all-zero RoIs."""
        feats = self.extract_feat(x)
        dummy = torch.zeros((4, feats[0].shape[1], 7, 7),
                            dtype=feats[0].dtype, device=x.device)
        return self.rpn_head(feats), self.roi_head.bbox_head(dummy)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init as erd_tpu's flax defaults: lecun-normal
        convs and fcs with zero biases; RPN convs N(0, 0.01), fc_cls
        N(0, 0.01), fc_reg N(0, 0.001), CARAFE content encoders
        N(0, 0.001)."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for m in self.modules():
            if isinstance(m, (Conv2d, Linear)):
                normal(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
        rpn = self.rpn_head
        for conv in (rpn.rpn_conv, rpn.rpn_cls, rpn.rpn_reg):
            normal(conv.weight, 0.01)
        for m in self.modules():
            if isinstance(m, CARAFEPack):
                normal(m.content_encoder.weight, 0.001)
        self.init_head(normal)

    def init_head(self, normal):
        normal(self.roi_head.bbox_head.fc_cls.weight, 0.01)
        normal(self.roi_head.bbox_head.fc_reg.weight, 0.001)


@dataclass
class FasterRCNNDetector:
    """Config + functions of Faster R-CNN."""
    num_classes: int = 80
    depth: int = 50
    compute_dtype: torch.dtype = torch.float32
    # stem + layer1 frozen (the 1x recipe): requires_grad=False in the net
    frozen_stages: int = 1
    # None (FPN) or an FPN_CARAFE spec dict
    neck: Optional[dict] = None
    preprocessor: Preprocessor = field(default_factory=Preprocessor)
    rpn_train_cfg: RPNTrainConfig = field(default_factory=RPNTrainConfig)
    rcnn_train_cfg: RCNNTrainConfig = field(default_factory=RCNNTrainConfig)
    proposal_cfg_train: ProposalConfig = field(
        default_factory=lambda: ProposalConfig(nms_pre=2000,
                                               max_per_img=1000))
    proposal_cfg_test: ProposalConfig = field(
        default_factory=lambda: ProposalConfig(nms_pre=1000,
                                               max_per_img=1000))
    test_cfg: GFLTestConfig = field(
        default_factory=lambda: GFLTestConfig(iou_threshold=0.5))

    def __post_init__(self):
        if self.preprocessor.compute_dtype != self.compute_dtype:
            self.preprocessor = replace(self.preprocessor,
                                        compute_dtype=self.compute_dtype)
        self.anchor_generator = rpn_anchor_generator()
        self.rpn_coder = DeltaXYWHBBoxCoder()
        self.rcnn_coder = DeltaXYWHBBoxCoder(
            target_stds=(0.1, 0.1, 0.2, 0.2))
        self._ctx_cache: Dict[Tuple[int, int], AnchorContext] = {}

    def anchor_context(self, image_shape) -> AnchorContext:
        key = tuple(int(v) for v in image_shape)
        if key not in self._ctx_cache:
            self._ctx_cache[key] = AnchorContext.build(
                key, self.anchor_generator)
        return self._ctx_cache[key]

    def build_net(self) -> FasterRCNNNet:
        return FasterRCNNNet(self.num_classes, depth=self.depth,
                             frozen_stages=self.frozen_stages,
                             param_dtype=self.compute_dtype, neck=self.neck)

    def init(self, seed: int = 0, device=None) -> FasterRCNNNet:
        """A seeded random network on ``device`` (``cuda`` unless the
        caller names one; raises without CUDA), in eval mode. The weights
        are drawn on the CPU, so a seed gives the same network anywhere."""
        net = self.build_net()
        net.init_weights(torch.Generator().manual_seed(seed))
        return net.to(resolve_device(device)).eval()

    @torch.no_grad()
    def forward_raw(self, net: FasterRCNNNet, images: torch.Tensor):
        """erd_tpu's mode='tensor': ((rpn_cls, rpn_reg) per level, NHWC;
        (cls, reg) of the bbox head on four zero RoIs)."""
        return net(self.preprocessor(images))

    @torch.no_grad()
    def feats_and_rpn(self, net: FasterRCNNNet, images: torch.Tensor):
        """(FPN levels NCHW, RPN objectness and deltas per level NHWC),
        all in the compute dtype but the float32 deltas."""
        feats = net.extract_feat(self.preprocessor(images))
        rpn_cls, rpn_reg = net.rpn_head(feats)
        return feats, rpn_cls, rpn_reg

    def proposals(self, ctx: AnchorContext, rpn_cls, rpn_reg, meta):
        """(boxes (B, 1000, 4), scores, mask) from the RPN outputs."""
        return rpn_proposals(ctx, [c.float() for c in rpn_cls],
                             [r.float() for r in rpn_reg], meta.img_shape,
                             self.rpn_coder, self.proposal_cfg_test)

    @staticmethod
    def roi_feats(feats, rois):
        """(B, R, 256, 7, 7) float32 RoIAlign of P2-P5 (compute-dtype maps
        read as they are and widened, as erd_tpu's astype(float32))."""
        return multilevel_roi_align(feats[:len(ROI_STRIDES)], rois,
                                    ROI_STRIDES)

    def head_outputs(self, net: FasterRCNNNet, roi_feats):
        """bbox head on (B, R, C, 7, 7) features -> float32 (cls (B, R,
        C+1), reg (B, R, 4C)), recording the autograd graph."""
        b, r = roi_feats.shape[:2]
        cls, reg = net.roi_head.bbox_head(roi_feats.flatten(0, 1))
        return cls.float().reshape(b, r, -1), reg.float().reshape(b, r, -1)

    @torch.no_grad()
    def roi_forward(self, net: FasterRCNNNet, roi_feats):
        """``head_outputs`` without autograd (serving)."""
        return self.head_outputs(net, roi_feats)

    def postprocess(self, cls_logits, reg_preds, rois, roi_mask, meta,
                    rescale=True) -> DetResults:
        return rcnn_predict(cls_logits, reg_preds, rois, roi_mask, meta,
                            self.num_classes, self.rcnn_coder,
                            self.test_cfg, rescale=rescale)

    @torch.no_grad()
    def predict(self, net: FasterRCNNNet, batch, rescale=True) -> DetResults:
        """DetResults in the original-image frame.

        batch: dict(images (B, H, W, 3) uint8, meta: ImageMeta of (B, ...)
        tensors), all on the network's device.
        """
        images = batch['images']
        feats, rpn_cls, rpn_reg = self.feats_and_rpn(net, images)
        return self.predict_from_feats(net, images.shape[1:3], feats,
                                       rpn_cls, rpn_reg, batch['meta'],
                                       rescale=rescale)

    @torch.no_grad()
    def predict_from_feats(self, net: FasterRCNNNet, canvas_shape, feats,
                           rpn_cls, rpn_reg, meta,
                           rescale=True) -> DetResults:
        """``predict`` after the network's first stage, for (H, W)
        canvases."""
        ctx = self.anchor_context(canvas_shape)
        rois, _, roi_mask = self.proposals(ctx, rpn_cls, rpn_reg, meta)
        cls, reg = self.roi_forward(net, self.roi_feats(feats, rois))
        return self.postprocess(cls, reg, rois, roi_mask, meta,
                                rescale=rescale)

    def train_draws(self, img_id, b, n_anchors, n_candidates, device):
        """The samplers' uniform keys: RPN positive and negative (B,
        n_anchors), R-CNN positive and negative (B, n_candidates), from a
        ``torch.Generator`` on ``device`` seeded with ``img_id.sum()``."""
        gen = torch.Generator(device=device).manual_seed(int(img_id.sum()))
        return tuple(torch.rand((b, n), generator=gen, device=device)
                     for n in (n_anchors, n_anchors, n_candidates,
                               n_candidates))

    def loss(self, net: FasterRCNNNet, batch, draws=None):
        """Training losses. batch: dict(images (B, H, W, 3) uint8, gt:
        GTInstances and meta: ImageMeta of (B, ...) tensors), all on the
        network's device. ``draws``: the four uniform key tensors of
        ``train_draws`` to use instead of its generator's. Returns
        dict(loss_rpn_cls, loss_rpn_bbox, loss_cls, loss_bbox) of 0-dim
        tensors."""
        images = batch['images']
        feats = net.extract_feat(self.preprocessor(images))
        rpn_cls, rpn_reg = net.rpn_head(feats)
        return self.loss_from_feats(net, images.shape[1:3], feats, rpn_cls,
                                    rpn_reg, batch['gt'], batch['meta'],
                                    draws)

    def loss_from_feats(self, net, canvas_shape, feats, rpn_cls, rpn_reg,
                        gt, meta, draws=None):
        """``loss`` after the network's first stage, for (H, W) canvases:
        FPN levels NCHW, RPN outputs per level NHWC."""
        ctx = self.anchor_context(canvas_shape)
        b = feats[0].shape[0]
        cls_flat = torch.cat([m.reshape(b, -1) for m in rpn_cls], 1).float()
        reg_flat = torch.cat([m.reshape(b, -1, 4) for m in rpn_reg], 1)
        if draws is None:
            draws = self.train_draws(
                meta.img_id, b, ctx.num_anchors,
                gt.mask.shape[1] + self.proposal_cfg_train.max_per_img,
                cls_flat.device)
        losses = rpn_loss(ctx, cls_flat, reg_flat, gt, meta.img_shape,
                          draws[0], draws[1], self.rpn_coder,
                          self.rpn_train_cfg)
        with torch.no_grad():
            rois, _, roi_mask = rpn_proposals(
                ctx, [c.float() for c in rpn_cls], rpn_reg, meta.img_shape,
                self.rpn_coder, self.proposal_cfg_train)
        samples = rcnn_sample(rois, roi_mask, gt, self.num_classes,
                              self.rcnn_coder, draws[2], draws[3],
                              self.rcnn_train_cfg)
        losses.update(self.rcnn_losses(net, feats, samples, gt, draws))
        return losses

    def rcnn_losses(self, net, feats, samples: RoISamples, gt, draws=None):
        """The R-CNN stage's losses on the sampled RoIs (``draws``: all of
        ``train_draws``' tensors, for heads that draw points)."""
        cls, reg = self.head_outputs(net, self.roi_feats(feats,
                                                         samples.rois))
        return rcnn_loss(cls, reg, samples, self.rcnn_train_cfg)
