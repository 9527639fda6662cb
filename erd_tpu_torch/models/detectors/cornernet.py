"""CornerNet (HourglassNet-104) serving and training; the counterpart of
erd_tpu/models/detectors/cornernet.py.

HourglassNet (2 stacks, stride 4) -> per stack two ``BiCornerPool``s
(top + left for the top-left corners, bottom + right for the bottom-right
ones; the kernel ``csrc/corner_pool.cu`` on CUDA tensors) and six
``CornerHeadBranch``es: class heatmaps, 1-d embeddings, 2-d offsets. Only
the last stack predicts: sigmoid and 3x3 ``local_maximum`` of each
heatmap, the top ``corner_topk`` over C * H * W (ties lowest index first,
as ``lax.top_k``), the dense K x K grid of (top-left i, bottom-right j)
pairs scored by the mean of the two scores and kept where the classes
match, the box is not inverted and |emb_i - emb_j| <= distance_threshold,
``score_thr``, the boxes scaled to the image, and gaussian soft-NMS
(sigma 0.5) over the K^2 = 10000 pairs (the soft-NMS kernel, a
cluster of 4 blocks). ``predict`` computes the first stack's features
but not its pools and heads, which only training reads (erd_tpu's jitted
predict drops them the same way); ``forward_raw`` returns both stacks.

erd_tpu's CornerNet runs in float32 whatever the config's compute_dtype
(its network never reads the field, its preprocessor and hourglass are
float32), and so does the port, with full-float32 convolutions. Modules
carry erd_tpu's scope names (``backbone``, ``tl_pool_1``, ``br_heat_1``,
...). The canvas sides must be multiples of 4 * 2^downsample_times (128
for HG-104): ``inference_detector(..., scale=(1024, 768))`` gives 768x1024
and 1024x768 canvases.

``loss`` runs the network in train mode, as erd_tpu's ``loss_and_state``
does: every BN of the hourglass and the corner pools normalises by its
batch statistics and updates its running statistics in place (flax's
momentum 0.9, biased variance). The targets come from
``render_corner_targets`` (kernel ``csrc/corner_targets.cu``); summed over
both stacks: the gaussian focal loss of each heatmap over its count of
exact-1 peaks (halved over the two corners), the pull / push of the
embeddings at the gt corners (0.1 each), and the smooth-L1 of the offsets
at the corner pixels over their count. The corner pools' gradient is
erd_tpu's (``corner_pool_backward``, 8 launches a step). As in erd_tpu's
trainer (``frozen_stages`` 1, whose ``stem_conv`` prefix names the
hourglass's stem), ``backbone.stem_conv`` is not trained.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...losses import (associative_embedding_loss, gaussian_focal_loss,
                       smooth_l1_loss)
from ...ops import corner_pool, local_maximum, nms_select, soft_nms_select
from ...ops.gaussian import render_corner_targets
from ...ops.misc import topk_stable
from ...structures import DetResults
from ...utils import resolve_device
from ..backbones.hourglass import ConvBN, HourglassNet
from ..layers import Conv2d, bias_init_prob
from ..preprocessor import Preprocessor

HEADS = ('heat', 'emb', 'off')
POOL_CHANNELS = 128
AE_WEIGHT = 0.10  # the pull and the push weight of the embedding loss


class BiCornerPool(nn.Module):
    """conv -> pool(direction 1) + conv -> pool(direction 2) -> conv-bn,
    plus a 1x1 conv-bn shortcut, ReLU, conv-bn-ReLU."""

    def __init__(self, in_ch: int, out_ch: int, directions: Tuple[str, str]):
        super().__init__()
        self.directions = directions
        self.direction1_conv = ConvBN(in_ch, POOL_CHANNELS, 3)
        self.direction2_conv = ConvBN(in_ch, POOL_CHANNELS, 3)
        self.aftpool_conv = ConvBN(POOL_CHANNELS, out_ch, 3, act=False)
        self.conv1 = ConvBN(in_ch, out_ch, 1, act=False)
        self.conv2 = ConvBN(out_ch, out_ch, 3)

    def forward(self, x):
        pooled = corner_pool(self.direction1_conv(x), self.directions[0]) + \
            corner_pool(self.direction2_conv(x), self.directions[1])
        return self.conv2(F.relu(self.aftpool_conv(pooled) + self.conv1(x)))


class CornerHeadBranch(nn.Module):
    """3x3 conv 256 (``feat``) + ReLU + 1x1 conv (``out``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.feat = Conv2d(in_ch, 256, 3)
        self.out = Conv2d(256, out_ch, 1)

    def forward(self, x):
        return self.out(F.relu(self.feat(x)))


class CornerNetNet(nn.Module):
    def __init__(self, num_classes: int, num_stacks: int = 2,
                 stage_channels: Sequence[int] = (256, 256, 384, 384, 384,
                                                  512),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 downsample_times: int = 5):
        super().__init__()
        self.num_stacks = num_stacks
        feat = stage_channels[0]
        self.backbone = HourglassNet(downsample_times, num_stacks,
                                     stage_channels, stage_blocks, feat)
        for i in range(num_stacks):
            for corner, dirs in (('tl', ('top', 'left')),
                                 ('br', ('bottom', 'right'))):
                self.add_module(f'{corner}_pool_{i}',
                                BiCornerPool(feat, 256, dirs))
                for head, ch in zip(HEADS, (num_classes, 1, 2)):
                    self.add_module(f'{corner}_{head}_{i}',
                                    CornerHeadBranch(256, ch))

    def heads(self, i: int, x) -> dict:
        """Stack i's outputs on its feature: {tl,br}_{heat,emb,off} NCHW."""
        out = {}
        for corner in ('tl', 'br'):
            pooled = getattr(self, f'{corner}_pool_{i}')(x)
            for head in HEADS:
                out[f'{corner}_{head}'] = getattr(
                    self, f'{corner}_{head}_{i}')(pooled)
        return out

    def forward(self, x):
        return [self.heads(i, f) for i, f in enumerate(self.backbone(x))]

    def last_stack(self, x) -> dict:
        """The last stack's outputs alone."""
        for feat in self.backbone.stacks(x):
            pass
        return self.heads(self.num_stacks - 1, feat)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init as erd_tpu's flax defaults: lecun-normal
        convs with zero biases, BN scale 1, bias 0, mean 0, var 1; the head
        branches' kernels N(0, 0.01), the heatmap biases at prior 0.1."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for name, m in self.named_modules():
            if isinstance(m, Conv2d):
                head = isinstance(getattr(self, name.split('.')[0]),
                                  CornerHeadBranch)
                normal(m.weight, 0.01 if head else
                       m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
        for i in range(self.num_stacks):
            for corner in ('tl', 'br'):
                getattr(self, f'{corner}_heat_{i}').out.bias.fill_(
                    bias_init_prob(0.1))


def topk_corners(scores, emb, off, k):
    """The top k of (B, C, H, W) scores over C * H * W: (score, class, x, y
    with the offsets added, embedding), each (B, k)."""
    b, _, h, w = scores.shape
    s, idx = topk_stable(scores.flatten(1), k)
    cls = torch.div(idx, h * w, rounding_mode='floor')
    pix = idx % (h * w)
    yy = torch.div(pix, w, rounding_mode='floor')
    xx = pix % w
    off = torch.gather(off.flatten(2), 2, pix[:, None].expand(b, 2, k))
    e = torch.gather(emb.flatten(2), 2, pix[:, None])[:, 0]
    return s, cls, xx.float() + off[:, 0], yy.float() + off[:, 1], e


@dataclass
class CornerNetDetector:
    """Config + functions of CornerNet."""
    num_classes: int = 80
    num_stacks: int = 2
    stage_channels: Tuple[int, ...] = (256, 256, 384, 384, 384, 512)
    stage_blocks: Tuple[int, ...] = (2, 2, 2, 2, 2, 4)
    downsample_times: int = 5
    corner_topk: int = 100
    distance_threshold: float = 0.5
    score_thr: float = 0.05
    max_per_img: int = 100
    nms_iou: float = 0.5
    # the published recipe tests with gaussian soft-NMS; 'nms' is greedy
    nms_type: str = 'soft_nms'
    soft_nms_sigma: float = 0.5
    # erd_tpu's trainer freezes the params under backbone/ whose name starts
    # with 'stem_conv' for frozen_stages >= 0 (its ResNet rule)
    frozen_stages: int = 1
    preprocessor: Preprocessor = field(default_factory=Preprocessor)

    def build_net(self) -> CornerNetNet:
        net = CornerNetNet(self.num_classes, self.num_stacks,
                           self.stage_channels, self.stage_blocks,
                           self.downsample_times)
        if self.frozen_stages >= 0:
            net.backbone.stem_conv.requires_grad_(False)
        return net

    def init(self, seed: int = 0, device=None) -> CornerNetNet:
        """A seeded random network on ``device`` (``cuda`` unless the
        caller names one; raises without CUDA), in eval mode; drawn on the
        CPU, so a seed gives the same network anywhere."""
        net = self.build_net()
        net.init_weights(torch.Generator().manual_seed(seed))
        return net.to(resolve_device(device)).eval()

    @torch.no_grad()
    def forward_raw(self, net: CornerNetNet, images: torch.Tensor):
        """erd_tpu's mode='tensor': both stacks' outputs, NCHW."""
        return net(self.preprocessor(images))

    def decode(self, out: dict, canvas_shape, meta, rescale=True):
        """The K x K pair grid of one stack's outputs: (boxes (B, K^2, 4),
        scores, labels, valid) in the image frame (canvas if not
        ``rescale``)."""
        k = self.corner_topk
        ih, iw = canvas_shape
        fh, fw = out['tl_heat'].shape[-2:]
        tls, tlc, tlx, tly, tle = topk_corners(
            local_maximum(torch.sigmoid(out['tl_heat'].float())),
            out['tl_emb'].float(), out['tl_off'].float(), k)
        brs, brc, brx, bry, bre = topk_corners(
            local_maximum(torch.sigmoid(out['br_heat'].float())),
            out['br_emb'].float(), out['br_off'].float(), k)
        b = tls.shape[0]
        score = (tls[:, :, None] + brs[:, None, :]) / 2.0
        valid = (tlc[:, :, None] == brc[:, None, :]) & \
            (brx[:, None, :] > tlx[:, :, None]) & \
            (bry[:, None, :] > tly[:, :, None]) & \
            ((tle[:, :, None] - bre[:, None, :]).abs() <=
             self.distance_threshold)
        scores = torch.where(valid, score, torch.full_like(score, -1.0))
        rx, ry = iw / fw, ih / fh
        boxes = torch.stack([(tlx * rx)[:, :, None].expand(b, k, k),
                             (tly * ry)[:, :, None].expand(b, k, k),
                             (brx * rx)[:, None, :].expand(b, k, k),
                             (bry * ry)[:, None, :].expand(b, k, k)], -1)
        boxes = boxes.reshape(b, k * k, 4)
        if rescale:
            inv = 1.0 / meta.scale_factor.float()
            boxes = boxes * torch.cat([inv, inv], -1)[:, None]
        scores = scores.reshape(b, k * k)
        labels = tlc[:, :, None].expand(b, k, k).reshape(b, k * k)
        return boxes, scores, labels, scores > self.score_thr

    def nms(self, boxes, scores, labels, valid) -> DetResults:
        if self.nms_type == 'soft_nms':
            out = soft_nms_select(
                boxes, scores, labels, self.max_per_img,
                iou_threshold=self.nms_iou, sigma=self.soft_nms_sigma,
                method='gaussian', valid_mask=valid)
        else:
            out = nms_select(boxes, scores, labels, self.nms_iou,
                             self.max_per_img, valid_mask=valid)
        return DetResults(*out, num_candidates=valid.sum(-1))

    @torch.no_grad()
    def predict(self, net: CornerNetNet, batch, rescale=True) -> DetResults:
        """DetResults in the original-image frame. batch: dict(images (B,
        H, W, 3) uint8, meta: ImageMeta of (B, ...) tensors), on the
        network's device."""
        images = batch['images']
        out = net.last_stack(self.preprocessor(images))
        return self.nms(*self.decode(out, images.shape[1:3], batch['meta'],
                                     rescale))

    def targets(self, gt, canvas_shape, feat_hw):
        """``render_corner_targets`` of a batch's gt on (H, W) canvases."""
        ih, iw = canvas_shape
        fh, fw = feat_hw
        return render_corner_targets(gt.bboxes, gt.labels, gt.mask,
                                     (fh, fw), self.num_classes,
                                     (fw / iw, fh / ih))

    def loss(self, net: CornerNetNet, batch):
        """Training losses: dict(loss_heatmap, loss_pull, loss_push,
        loss_offset) of 0-dim tensors, summed over the stacks. The network
        runs in train mode and its BN running statistics update in place.
        batch: dict(images (B, H, W, 3) uint8, gt: GTInstances of (B, G,
        ...)), on the network's device."""
        images = batch['images']
        with train_mode(net):
            outs = net(self.preprocessor(images))
        gt = batch['gt']
        tgt = self.targets(gt, images.shape[1:3],
                           outs[0]['tl_heat'].shape[-2:])
        avg = {c: (tgt[f'{c}_heat'] == 1.0).sum().float().clamp(min=1.0)
               for c in ('tl', 'br')}
        avg_off = (tgt['tl_w'].sum() + tgt['br_w'].sum()).clamp(min=1.0)
        losses = dict(loss_heatmap=0.0, loss_pull=0.0, loss_push=0.0,
                      loss_offset=0.0)
        for out in outs:
            heat = sum(gaussian_focal_loss(
                torch.sigmoid(out[f'{c}_heat'].float()), tgt[f'{c}_heat'],
                alpha=2.0, gamma=4.0, reduction='none').sum() / avg[c]
                for c in ('tl', 'br'))
            losses['loss_heatmap'] = losses['loss_heatmap'] + heat / 2.0
            emb = [corner_values(out[f'{c}_emb'].float(), tgt[f'{c}_xy'])
                   for c in ('tl', 'br')]
            pull, push = associative_embedding_loss(*emb, gt.mask,
                                                    AE_WEIGHT, AE_WEIGHT)
            losses['loss_pull'] = losses['loss_pull'] + pull.mean()
            losses['loss_push'] = losses['loss_push'] + push.mean()
            off = sum((smooth_l1_loss(out[f'{c}_off'].float(),
                                      tgt[f'{c}_off'], beta=1.0,
                                      reduction='none') *
                       tgt[f'{c}_w']).sum() for c in ('tl', 'br'))
            losses['loss_offset'] = losses['loss_offset'] + off / avg_off
        return losses


@contextlib.contextmanager
def train_mode(net: nn.Module):
    """``net`` in train mode within the block, then back in its mode."""
    was = net.training
    net.train()
    try:
        yield net
    finally:
        net.train(was)


def corner_values(emb, xy):
    """(B, 1, H, W) maps at (B, G, 2) (x, y) pixels -> (B, G); pixels
    clipped onto the map, as XLA's gather clips them."""
    b, _, h, w = emb.shape
    x = xy[..., 0].long().clamp(0, w - 1)
    y = xy[..., 1].long().clamp(0, h - 1)
    return torch.gather(emb.flatten(1), 1, y * w + x)
