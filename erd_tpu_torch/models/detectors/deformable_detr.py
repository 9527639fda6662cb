"""Deformable DETR R50 serving and training; the counterpart of
erd_tpu/models/detectors/deformable_detr.py.

ResNet (frozen BN) C3-C5 -> ChannelMapper (1x1 convs + GN, one extra 3x3/2
level on the raw C5) -> float32 maps -> ``DeformableDETRHead`` -> NMS-free
prediction: the sigmoid top-k over queries x classes; ``loss`` is the
Hungarian set loss of every decoder layer. As in erd_tpu, the detector is
configuration plus functions and the network holds the weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.misc import take_rows, topk_stable
from ...structures import DetResults, cxcywh_to_xyxy, scale_boxes
from ...utils import resolve_device
from ..backbones.resnet import ResNet
from ..heads.deformable_detr_head import (DeformableDETRHead,
                                          DeformableDETRTrainConfig,
                                          deform_attn_modules,
                                          deformable_detr_loss)
from ..layers import Conv2d, Linear
from ..necks.channel_mapper import ChannelMapper
from ..preprocessor import Preprocessor


class DETRNet(nn.Module):
    """backbone -> neck -> bbox_head under erd_tpu's scope names; the head
    is Deformable DETR's or DINO's. ``frozen_stages`` as ResNet's."""

    def __init__(self, bbox_head: nn.Module, depth: int = 50,
                 embed_dim: int = 256, frozen_stages: int = -1):
        super().__init__()
        self.backbone = ResNet(depth, frozen_stages=frozen_stages)
        self.neck = ChannelMapper(self.backbone.out_channels[1:], embed_dim,
                                  kernel_size=1, num_outs=4)
        self.bbox_head = bbox_head

    def extract_feat(self, x):
        """C3-C5 + the extra level, as float32 (B, C, H, W) maps: the head
        runs on float32 maps (erd_tpu's astype(float32))."""
        return [f.float() for f in self.neck(self.backbone(x)[1:])]

    def forward(self, x, *head_args):
        return self.bbox_head(self.extract_feat(x), *head_args)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init as erd_tpu's flax defaults: lecun-normal
        convs and dense layers with zero biases, N(0, 1) level embeddings
        and query embeddings, N(0, 1 / C) label embeddings; zero
        ``sampling_offsets`` and ``attention_weights``; then the head's own
        ``init_extra`` (DINO zeroes its ``fc_reg``)."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for m in self.modules():
            if isinstance(m, (Conv2d, Linear)):
                normal(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal(m.weight, m.weight.shape[1] ** -0.5)
        head = self.bbox_head
        for p in head.parameters(recurse=False):  # the embeddings
            normal(p, 1.0)
        for m in deform_attn_modules(head):
            m.sampling_offsets.weight.zero_()
            m.attention_weights.weight.zero_()
        head.init_extra()


def head_outputs(outs):
    """(all_cls, all_boxes) of a head's forward: Deformable DETR's tuple
    or DINO's dict."""
    if isinstance(outs, dict):
        return outs['all_cls'], outs['all_boxes']
    return outs


def detr_predict(all_cls, all_boxes, canvas_hw, meta, num_classes: int,
                 max_per_img: int, rescale: bool = True) -> DetResults:
    """NMS-free prediction from the last decoder layer: sigmoid top-k over
    Q x classes (ties lowest index first), query idx // C and label
    idx % C, cxcywh boxes times the canvas, clipped to the image, then
    rescaled to the original image."""
    cls = all_cls[-1].float()
    boxes = all_boxes[-1].float()
    b = cls.shape[0]
    prob = torch.sigmoid(cls).reshape(b, -1)
    k = min(max_per_img, prob.shape[1])
    top, idx = topk_stable(prob, k)
    qidx = torch.div(idx, num_classes, rounding_mode='floor')
    labels = (idx % num_classes).to(torch.int32)
    ch, cw = canvas_hw
    norm = torch.tensor([cw, ch, cw, ch], dtype=torch.float32,
                        device=cls.device)
    bx = cxcywh_to_xyxy(take_rows(boxes, qidx)) * norm
    h, w = meta.img_shape[:, 0], meta.img_shape[:, 1]
    bx = torch.minimum(bx.clamp(min=0),
                       torch.stack([w, h, w, h], -1)[:, None, :])
    if rescale:
        bx = scale_boxes(bx, 1.0 / meta.scale_factor)
    return DetResults(bboxes=bx, scores=top, labels=labels, mask=top > 0)


@dataclass
class DeformableDETRDetector:
    """Config + functions of Deformable DETR serving and training."""
    num_classes: int = 80
    depth: int = 50
    num_queries: int = 300
    compute_dtype: torch.dtype = torch.float32
    max_per_img: int = 100
    # stem + layer1 frozen, erd_tpu's trainer default
    frozen_stages: int = 1
    preprocessor: Preprocessor = field(default_factory=Preprocessor)
    train_cfg: DeformableDETRTrainConfig = field(
        default_factory=DeformableDETRTrainConfig)

    def __post_init__(self):
        if self.preprocessor.compute_dtype != self.compute_dtype:
            self.preprocessor = replace(self.preprocessor,
                                        compute_dtype=self.compute_dtype)

    def build_net(self) -> DETRNet:
        return DETRNet(DeformableDETRHead(
            self.num_classes, num_queries=self.num_queries,
            param_dtype=self.compute_dtype), self.depth,
            frozen_stages=self.frozen_stages)

    def init(self, seed: int = 0, device=None) -> DETRNet:
        """A seeded random network on ``device`` (``cuda`` unless the
        caller names one; raises without CUDA), in eval mode. The weights
        are drawn on the CPU, so a seed gives the same network anywhere."""
        net = self.build_net()
        net.init_weights(torch.Generator().manual_seed(seed))
        return net.to(resolve_device(device)).eval()

    @torch.no_grad()
    def extract_feat(self, net: DETRNet, images: torch.Tensor):
        """(B, H, W, 3) uint8 -> the head's four float32 maps."""
        return net.extract_feat(self.preprocessor(images))

    @torch.no_grad()
    def forward_raw(self, net: DETRNet, images: torch.Tensor):
        """erd_tpu's ``forward_raw``: (all_cls, all_boxes) of every decoder
        layer (DINO: a dict that also holds enc_cls and enc_boxes)."""
        return net.bbox_head(self.extract_feat(net, images))

    def postprocess(self, all_cls, all_boxes, canvas_hw, meta,
                    rescale=True) -> DetResults:
        return detr_predict(all_cls, all_boxes, canvas_hw, meta,
                            self.num_classes, self.max_per_img, rescale)

    @torch.no_grad()
    def predict(self, net: DETRNet, batch, rescale=True) -> DetResults:
        """DetResults in the original-image frame; batch: dict(images (B,
        H, W, 3) uint8, meta: ImageMeta of (B, ...) tensors) on the
        network's device."""
        images = batch['images']
        all_cls, all_boxes = head_outputs(self.forward_raw(net, images))
        return self.postprocess(all_cls, all_boxes, images.shape[1:3],
                                batch['meta'], rescale)

    def loss(self, net: DETRNet, batch, matches: Optional[Sequence] = None):
        """Training losses. batch: dict(images (B, H, W, 3) uint8, gt:
        GTInstances, meta: ImageMeta of (B, ...) tensors) on the network's
        device. The decoder outputs are cast to float32 before the loss.
        ``matches``: one (B, Q) assignment per decoder layer to use
        instead of the Hungarian solver's. Returns dict(loss_cls,
        loss_bbox, loss_giou and their ``_aux{i}``) of 0-dim tensors."""
        images = batch['images']
        all_cls, all_boxes = net(self.preprocessor(images))
        return deformable_detr_loss(all_cls.float(), all_boxes.float(),
                                    batch['gt'], images.shape[1:3],
                                    self.num_classes, self.train_cfg,
                                    matches)
