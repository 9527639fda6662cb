"""Faster R-CNN (R50-FPN) serving; the counterpart of
erd_tpu/models/detectors/faster_rcnn.py.

ResNet (frozen BN) -> FPN P2-P6 (``start_level=0``, P6 by a stride-2
subsample) -> RPN -> 1000 padded proposals per image -> RoIAlign 7x7 on
P2-P5 (kernel ``csrc/roi_align.cu``) -> Shared2FC bbox head -> per-class
decode, top-2000 and hard or soft NMS. As in erd_tpu, the detector is
configuration plus functions and ``FasterRCNNNet`` holds the weights.
Training is not ported yet: ``loss`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

import torch
from torch import nn

from ...ops import multilevel_roi_align
from ...structures import DetResults
from ...task import DeltaXYWHBBoxCoder
from ...utils import resolve_device
from ..backbones.resnet import ResNet
from ..heads.bbox_head import Shared2FCBBoxHead, rcnn_predict
from ..heads.gfl_head import AnchorContext, GFLTestConfig
from ..heads.rpn_head import (ProposalConfig, RPNHeadNet,
                              rpn_anchor_generator, rpn_proposals)
from ..layers import Conv2d, Linear
from ..necks.fpn import FPN
from ..preprocessor import Preprocessor

ROI_STRIDES = (4, 8, 16, 32)  # the levels RoIAlign samples: P2-P5


class RoIHead(nn.Module):
    """Holds ``bbox_head`` under mmdet's ``roi_head.bbox_head`` names."""

    def __init__(self, num_classes: int, param_dtype: torch.dtype):
        super().__init__()
        self.bbox_head = Shared2FCBBoxHead(num_classes,
                                           param_dtype=param_dtype)


class FasterRCNNNet(nn.Module):
    """backbone -> neck -> rpn_head, and roi_head.bbox_head; mmdet names."""

    def __init__(self, num_classes: int, depth: int = 50,
                 frozen_stages: int = -1,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNet(depth, frozen_stages=frozen_stages)
        self.neck = FPN(in_channels=self.backbone.out_channels,
                        out_channels=256, num_outs=5, start_level=0,
                        add_extra_convs='')
        self.rpn_head = RPNHeadNet()
        self.roi_head = RoIHead(num_classes, param_dtype)

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
        N(0, 0.01), fc_reg N(0, 0.001)."""
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
        normal(self.roi_head.bbox_head.fc_cls.weight, 0.01)
        normal(self.roi_head.bbox_head.fc_reg.weight, 0.001)


@dataclass
class FasterRCNNDetector:
    """Config + functions of Faster R-CNN serving."""
    num_classes: int = 80
    depth: int = 50
    compute_dtype: torch.dtype = torch.float32
    # stem + layer1 frozen (the 1x recipe); serving does not read it
    frozen_stages: int = 1
    preprocessor: Preprocessor = field(default_factory=Preprocessor)
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
                             param_dtype=self.compute_dtype)

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

    @torch.no_grad()
    def roi_forward(self, net: FasterRCNNNet, roi_feats):
        """bbox head on (B, R, C, 7, 7) features -> float32 (cls (B, R,
        C+1), reg (B, R, 4C))."""
        b, r = roi_feats.shape[:2]
        cls, reg = net.roi_head.bbox_head(roi_feats.flatten(0, 1))
        return cls.float().reshape(b, r, -1), reg.float().reshape(b, r, -1)

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

    def loss(self, net, batch):
        raise NotImplementedError(
            'Faster R-CNN training is not ported yet (ROADMAP.md, section '
            '1, item 1)')
