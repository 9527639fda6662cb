"""VarifocalNet (VFNet); the counterpart of erd_tpu/models/detectors/vfnet.py.

ResNet (frozen BN; DCNv2 stages in the mdconv recipes) -> FPN (on_output
extras, ReLU before the second) -> the star-DCN VFNet head -> refined boxes
at the grid points -> ``vfnet_predict`` in serving, or both boxes and the
logits -> ``vfnet_loss`` in training. As in erd_tpu, the detector is
configuration plus functions and the network holds the weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

import torch
from torch import nn

from ...ops.deform_conv import DeformConv2d, ModulatedDeformConv
from ...utils import resolve_device
from ..backbones.resnet import ResNet
from ..heads.gfl_head import GFLTestConfig
from ..heads.vfnet_head import (VFNetContext, VFNetHeadNet, decode_levels,
                                vfnet_loss, vfnet_predict)
from ..layers import Conv2d, bias_init_prob
from ..necks.fpn import FPN
from ..preprocessor import Preprocessor


class VFNetNet(nn.Module):
    """backbone -> neck -> bbox_head; module names are mmdet's."""

    def __init__(self, num_classes: int, depth: int = 50,
                 frozen_stages: int = -1,
                 dcn_stages=(False, False, False, False),
                 dcn_modulated: bool = True):
        super().__init__()
        self.backbone = ResNet(depth, frozen_stages=frozen_stages,
                               dcn_stages=dcn_stages,
                               dcn_modulated=dcn_modulated)
        self.neck = FPN(in_channels=self.backbone.out_channels,
                        out_channels=256, num_outs=5, start_level=1,
                        relu_before_extra_convs=True)
        self.bbox_head = VFNetHeadNet(num_classes)

    def forward(self, x):
        return self.bbox_head(self.neck(self.backbone(x)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init as erd_tpu's: lecun-normal backbone and neck
        convs with zero bias, zero ``conv_offset`` and he-normal weights of
        the deformable convs, N(0, 0.01) head convs, the vfnet_cls bias at
        the 0.01 prior."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for m in self.modules():
            if isinstance(m, Conv2d):
                normal(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, ModulatedDeformConv):
                m.init_weights(generator)
            elif isinstance(m, DeformConv2d):
                normal(m.weight, (2.0 / m.weight[0].numel()) ** 0.5)
        head = self.bbox_head
        for conv in [c.conv for c in list(head.cls_convs) +
                     list(head.reg_convs) + [head.vfnet_reg_conv]] + \
                [head.vfnet_reg, head.vfnet_reg_refine, head.vfnet_cls]:
            normal(conv.weight, 0.01)
        head.vfnet_cls.bias.fill_(bias_init_prob(0.01))


@dataclass
class VFNetDetector:
    """Config + functions of VFNet."""
    num_classes: int = 80
    depth: int = 50
    compute_dtype: torch.dtype = torch.float32
    # stem + layer1 frozen, as erd_tpu's trainer freezes every model
    frozen_stages: int = 1
    dcn_stages: Tuple[bool, ...] = (False, False, False, False)
    dcn_modulated: bool = True  # VFNet ships mdconv (DCNv2) variants only
    preprocessor: Preprocessor = field(default_factory=Preprocessor)
    test_cfg: GFLTestConfig = field(
        default_factory=lambda: GFLTestConfig(iou_threshold=0.6))

    def __post_init__(self):
        self._ctx_cache: Dict[Tuple[int, int], VFNetContext] = {}
        if self.preprocessor.compute_dtype != self.compute_dtype:
            self.preprocessor = replace(self.preprocessor,
                                        compute_dtype=self.compute_dtype)

    def context(self, image_shape) -> VFNetContext:
        key = tuple(int(v) for v in image_shape)
        if key not in self._ctx_cache:
            self._ctx_cache[key] = VFNetContext.build(key)
        return self._ctx_cache[key]

    def build_net(self) -> VFNetNet:
        return VFNetNet(self.num_classes, self.depth, self.frozen_stages,
                        tuple(self.dcn_stages), self.dcn_modulated)

    def init(self, seed: int = 0, device=None) -> VFNetNet:
        """A seeded random network on ``device`` (``cuda`` unless the
        caller names one; raises without CUDA), in eval mode. The weights
        are drawn on the CPU, so a seed gives the same network anywhere."""
        net = self.build_net()
        net.init_weights(torch.Generator().manual_seed(seed))
        return net.to(resolve_device(device)).eval()

    @torch.no_grad()
    def forward_raw(self, net: VFNetNet, images: torch.Tensor):
        """Per-level (cls_scores, bbox_inis, bbox_refines), float32 NHWC,
        from (B, H, W, 3) uint8 canvases."""
        return net(self.preprocessor(images))

    def postprocess(self, ctx, cls_lvl, ref_lvl, meta, rescale=True):
        """Decode the refined distances, then ``vfnet_predict``."""
        return vfnet_predict(ctx, cls_lvl, decode_levels(ctx, ref_lvl), meta,
                             self.test_cfg, self.num_classes, rescale)

    @torch.no_grad()
    def predict(self, net: VFNetNet, batch, rescale=True):
        """DetResults in the original-image frame; batch: dict(images (B,
        H, W, 3) uint8, meta: ImageMeta of (B, ...) tensors) on the
        network's device."""
        images = batch['images']
        cls_lvl, _, ref_lvl = self.forward_raw(net, images)
        return self.postprocess(self.context(images.shape[1:3]), cls_lvl,
                                ref_lvl, batch['meta'], rescale)

    def loss(self, net: VFNetNet, batch):
        """VFNet training losses. batch: dict(images (B, H, W, 3) uint8,
        gt: GTInstances of (B, ...) tensors), on the network's device.
        Returns dict(loss_cls, loss_bbox, loss_bbox_rf) of 0-dim tensors."""
        images = batch['images']
        ctx = self.context(images.shape[1:3])
        cls_lvl, ini_lvl, ref_lvl = net(self.preprocessor(images))
        b = images.shape[0]

        def flat(levels, width):
            return torch.cat([m.reshape(b, -1, width) for m in levels], 1)
        return vfnet_loss(ctx, flat(cls_lvl, self.num_classes),
                          flat(decode_levels(ctx, ini_lvl), 4),
                          flat(decode_levels(ctx, ref_lvl), 4), batch['gt'],
                          self.num_classes)
