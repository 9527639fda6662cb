"""Single-stage GFL detector; the counterpart of
erd_tpu/models/detectors/single_stage.py.

As in erd_tpu, the detector is configuration plus functions and the weights
live apart: ``GFLNet`` is the nn.Module holding them (erd_tpu's
``variables``), and ``GFLDetector.forward_raw(net, images)`` /
``predict(net, batch)`` / ``loss(net, batch)`` take it as their first
argument. ``forward_raw`` and ``predict`` serve without autograd;
``forward_train`` and ``loss`` record the graph for training.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

import torch
from torch import nn

from ...ops.deform_conv import ModulatedDeformConv
from ...task import AnchorGenerator
from ...utils import resolve_device
from ..backbones.resnet import ResNet
from ..heads.gfl_head import (AnchorContext, GFLHeadNet, GFLTestConfig,
                              GFLTrainConfig, flatten_levels, gfl_loss,
                              gfl_predict, gfl_targets)
from ..layers import Conv2d, bias_init_prob
from ..necks.fpn import FPN
from ..preprocessor import Preprocessor


class GFLNet(nn.Module):
    """backbone -> neck -> bbox_head; module names are mmdet's.
    ``dcn_stages`` / ``dcn_modulated``: the backbone's deformable stages."""

    def __init__(self, num_classes: int, depth: int = 50,
                 neck_out: int = 256, stacked_convs: int = 4,
                 reg_max: int = 16, frozen_stages: int = -1,
                 dcn_stages=(False, False, False, False),
                 dcn_modulated: bool = True):
        super().__init__()
        self.backbone = ResNet(depth, frozen_stages=frozen_stages,
                               dcn_stages=dcn_stages,
                               dcn_modulated=dcn_modulated)
        self.neck = FPN(in_channels=self.backbone.out_channels,
                        out_channels=neck_out, num_outs=5, start_level=1)
        self.bbox_head = GFLHeadNet(num_classes, in_channels=neck_out,
                                    feat_channels=neck_out,
                                    stacked_convs=stacked_convs,
                                    reg_max=reg_max)

    def forward(self, x):
        return self.bbox_head(self.neck(self.backbone(x)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init: lecun-normal convs with zero bias, as
        erd_tpu's flax defaults; deformable convs as erd_tpu's (zero
        ``conv_offset``, he-normal weight); the head's convs N(0, 0.01); the
        gfl_cls bias at the 0.01 prior."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) *
                               fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, ModulatedDeformConv):
                m.init_weights(generator)
        head = self.bbox_head
        for conv in [c.conv for c in list(head.cls_convs) +
                     list(head.reg_convs)] + [head.gfl_cls, head.gfl_reg]:
            conv.weight.copy_(torch.randn(conv.weight.shape,
                                          generator=generator) * 0.01)
        head.gfl_cls.bias.fill_(bias_init_prob(0.01))


@dataclass
class GFLDetector:
    """Config + functions of the GFL detector."""
    num_classes: int = 80
    depth: int = 50
    reg_max: int = 16
    compute_dtype: torch.dtype = torch.float32
    # stem + layer1 frozen: the reference 1x recipe
    frozen_stages: int = 1
    # deformable 3x3 per backbone stage; DCNv2 (modulated) or DCNv1
    dcn_stages: Tuple[bool, ...] = (False, False, False, False)
    dcn_modulated: bool = True
    preprocessor: Preprocessor = field(default_factory=Preprocessor)
    anchor_generator: AnchorGenerator = field(default_factory=AnchorGenerator)
    train_cfg: GFLTrainConfig = field(default_factory=GFLTrainConfig)
    test_cfg: GFLTestConfig = field(default_factory=GFLTestConfig)

    def __post_init__(self):
        self._ctx_cache: Dict[Tuple[int, int], AnchorContext] = {}
        if self.preprocessor.compute_dtype != self.compute_dtype:
            self.preprocessor = replace(self.preprocessor,
                                        compute_dtype=self.compute_dtype)

    def anchor_context(self, image_shape) -> AnchorContext:
        key = tuple(int(v) for v in image_shape)
        if key not in self._ctx_cache:
            self._ctx_cache[key] = AnchorContext.build(
                key, self.anchor_generator)
        return self._ctx_cache[key]

    def build_net(self) -> GFLNet:
        return GFLNet(self.num_classes, depth=self.depth,
                      reg_max=self.reg_max, frozen_stages=self.frozen_stages,
                      dcn_stages=tuple(self.dcn_stages),
                      dcn_modulated=self.dcn_modulated)

    def init(self, seed: int = 0, device=None) -> GFLNet:
        """A seeded random network on ``device`` (``cuda`` unless the
        caller names one; raises without CUDA), in eval mode. The weights
        are drawn on the CPU, so a seed gives the same network anywhere."""
        net = self.build_net()
        net.init_weights(torch.Generator().manual_seed(seed))
        return net.to(resolve_device(device)).eval()

    @torch.no_grad()
    def forward_raw(self, net: GFLNet, images: torch.Tensor):
        """Per-level (cls_scores, bbox_preds), NHWC, from (B, H, W, 3)
        uint8 canvases; no autograd graph (serving)."""
        return net(self.preprocessor(images))

    def forward_train(self, net: GFLNet, images: torch.Tensor):
        """``forward_raw`` recording the autograd graph (erd_tpu's
        differentiable ``forward_raw``)."""
        return net(self.preprocessor(images))

    def loss(self, net: GFLNet, batch):
        """GFL training losses. batch: dict(images (B, H, W, 3) uint8,
        gt: GTInstances and meta: ImageMeta of (B, ...) tensors), all on
        the network's device. Returns dict(loss_cls, loss_bbox, loss_dfl)
        of 0-dim tensors."""
        images = batch['images']
        ctx = self.anchor_context(images.shape[1:3])
        cls_lvl, reg_lvl = self.forward_train(net, images)
        targets = gfl_targets(ctx, batch['gt'], batch['meta'].img_shape,
                              self.num_classes,
                              topk=self.train_cfg.assigner_topk,
                              pad_divisor=self.train_cfg.pad_divisor)
        return gfl_loss(ctx, flatten_levels(cls_lvl).float(),
                        flatten_levels(reg_lvl).float(), targets,
                        self.train_cfg, reg_max=self.reg_max)

    @torch.no_grad()
    def predict(self, net: GFLNet, batch, rescale=True):
        """DetResults in the original-image frame.

        batch: dict(images (B, H, W, 3) uint8, meta: ImageMeta of (B, ...)
        tensors), all on the network's device.
        """
        images = batch['images']
        ctx = self.anchor_context(images.shape[1:3])
        cls_lvl, reg_lvl = self.forward_raw(net, images)
        return self.postprocess(ctx, cls_lvl, reg_lvl, batch['meta'],
                                rescale=rescale)

    def postprocess(self, ctx, cls_lvl, reg_lvl, meta, rescale=True):
        """gfl_predict on head outputs, cast to float32 first."""
        return gfl_predict(ctx, [c.float() for c in cls_lvl],
                           [r.float() for r in reg_lvl], meta,
                           self.test_cfg, reg_max=self.reg_max,
                           rescale=rescale)
