"""SOLOv2 (R50-FPN) serving; the counterpart of
erd_tpu/models/detectors/solov2.py.

ResNet (frozen BN) -> FPN P2-P6 (``start_level=0``, P6 by a stride-2
subsample) -> the mask feature head (levels 0-3 convolved and upsampled to
stride 4, coordinate channels on level 3, summed, 1x1 to 256 channels) and
the SOLOv2 head (level 0 halved and level 4 resized to level 3, then each
level with coordinate channels resized to its S x S grid, S = 40, 36, 24,
16, 12; a kernel branch predicting a 256-d dynamic 1x1 conv per cell and a
class branch). As in erd_tpu, the detector is configuration plus functions
and ``SOLOV2Net`` holds the weights, under erd_tpu's scope names.

``predict``: sigmoid cell scores, the top ``nms_pre`` cells over
``score_thr``, their dynamic convs on the mask features as one IEEE float32
product, maskness rescoring, the mask-IoU matrix of the binarised masks
(a 0/1 product, exact in float32), the matrix-NMS decay (the kernel
``csrc/extra_nms.cu`` through ``matrix_decay``: one call a batch, its two
launches counted in ``matrix_decay.launches``), ``filter_thr``, the top ``max_per_img``, boxes
from the masks' extents and 28x28 box-normalised crops: (DetResults, crops
(B, 100, 28, 28)), as erd_tpu's.

Resizes are ``jax.image.resize``'s bilinear: a triangle filter widened by
the scale where an axis shrinks (antialiasing), which is
``F.interpolate(antialias=True)``; a plain bilinear shrink would average
2x2 blocks instead. Training is not ported yet: ``loss`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import matrix_decay
from ...ops.misc import take_rows, topk_stable
from ...structures import DetResults, scale_boxes
from ...utils import matmul_fp32_precision, resolve_device
from ..backbones.resnet import ResNet
from ..layers import Conv2d, ConvModule, bias_init_prob
from ..necks import FPN
from ..preprocessor import Preprocessor

NUM_GRIDS = (40, 36, 24, 16, 12)
SCALE_RANGES = ((1, 96), (48, 192), (96, 384), (192, 768), (384, 2048))
GRID_STRIDES = (8, 8, 16, 32, 32)
TRAIN_ITEM = 'ROADMAP.md, section 1: "SOLOv2 training"'


def _coord_channels(h, w, dtype, device):
    """(2, h, w): x then y coordinates from -1 to 1, as erd_tpu's
    ``jnp.linspace(-1, 1, n, dtype)``: start * (1 - t) + stop * t with t =
    i / (n - 1), each op in ``dtype``, the last point exactly 1."""
    def linspace(n):
        if n == 1:
            return torch.full((1,), -1.0, dtype=dtype, device=device)
        t = torch.arange(n - 1, dtype=dtype, device=device) / \
            torch.tensor(n - 1, dtype=dtype, device=device)
        head = -1.0 * (1 - t) + 1.0 * t
        return torch.cat([head, torch.ones(1, dtype=dtype, device=device)])
    ys, xs = linspace(h), linspace(w)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])


def _with_coords(x):
    """``x`` (B, C, H, W) with the two coordinate channels appended."""
    b, _, h, w = x.shape
    coords = _coord_channels(h, w, x.dtype, x.device)
    return torch.cat([x, coords[None].expand(b, 2, h, w)], 1)


def _resize(x, hw):
    """erd_tpu's ``jax.image.resize(..., 'bilinear')`` of (B, C, H, W) to
    ``hw``: half-pixel bilinear, antialiased on the axes that shrink;
    computed in float32 (torch's antialiased resize takes no bf16 on the
    CPU) and returned in x's dtype."""
    hw = tuple(int(v) for v in hw)
    if tuple(x.shape[-2:]) == hw:
        return x
    return F.interpolate(x.float(), size=hw, mode='bilinear',
                         align_corners=False, antialias=True).to(x.dtype)


class MaskFeatureHead(nn.Module):
    """FPN levels 0-3 -> one (B, 256, H/4, W/4) mask feature map; erd_tpu's
    scopes ``lvl{i}_conv0``, ``lvl{i}_up{j}``, ``conv_pred``."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 128,
                 out_channels: int = 256, num_levels: int = 4):
        super().__init__()
        self.num_levels = num_levels
        for i in range(num_levels):
            first = in_channels + (2 if i == num_levels - 1 else 0)
            self.add_module(f'lvl{i}_conv0',
                            ConvModule(first, feat_channels, 3))
            for j in range(i):
                self.add_module(f'lvl{i}_up{j}',
                                ConvModule(feat_channels, feat_channels, 3))
        self.conv_pred = ConvModule(feat_channels, out_channels, 1)

    def forward(self, feats):
        target_hw = feats[0].shape[-2:]
        summed = None
        for i in range(self.num_levels):
            x = feats[i]
            if i == self.num_levels - 1:
                x = _with_coords(x)
            x = getattr(self, f'lvl{i}_conv0')(x)
            for j in range(i):
                x = _resize(x, (x.shape[-2] * 2, x.shape[-1] * 2))
                x = getattr(self, f'lvl{i}_up{j}')(x)
            x = _resize(x, target_hw)
            summed = x if summed is None else summed + x
        return self.conv_pred(summed)


class SOLOV2HeadNet(nn.Module):
    """The kernel and class branches on the five grids; erd_tpu's scopes
    ``kernel_conv_i``, ``cls_conv_i`` (shared by the levels), ``conv_kernel``
    and ``conv_cls``. The convs compute in the input's dtype. Returns
    (kernel predictions (B, S, S, 256), class logits (B, S, S, C)) per
    level, NHWC float32."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 512, stacked_convs: int = 4,
                 kernel_out: int = 256):
        super().__init__()
        self.stacked_convs = stacked_convs
        for i in range(stacked_convs):
            self.add_module(f'kernel_conv_{i}', ConvModule(
                in_channels + 2 if i == 0 else feat_channels, feat_channels,
                3))
            self.add_module(f'cls_conv_{i}', ConvModule(
                in_channels if i == 0 else feat_channels, feat_channels, 3))
        self.conv_kernel = Conv2d(feat_channels, kernel_out, 3)
        self.conv_cls = Conv2d(feat_channels, num_classes, 3)

    def forward(self, feats):
        lvls = list(feats)
        lvls[0] = _resize(lvls[0], (lvls[0].shape[-2] // 2,
                                    lvls[0].shape[-1] // 2))
        lvls[4] = _resize(lvls[4], lvls[3].shape[-2:])
        kernel_preds, cls_preds = [], []
        for lvl, x in enumerate(lvls):
            s = NUM_GRIDS[lvl]
            xk = _resize(_with_coords(x), (s, s))
            xc = xk[:, :-2]
            for i in range(self.stacked_convs):
                xk = getattr(self, f'kernel_conv_{i}')(xk)
                xc = getattr(self, f'cls_conv_{i}')(xc)
            kernel_preds.append(
                self.conv_kernel(xk).float().permute(0, 2, 3, 1))
            cls_preds.append(self.conv_cls(xc).float().permute(0, 2, 3, 1))
        return kernel_preds, cls_preds


class SOLOV2Net(nn.Module):
    """backbone -> neck -> mask_feature_head and mask_head; returns
    (kernel predictions, class logits) per level NHWC float32 and the mask
    features (B, 256, H/4, W/4) float32."""

    def __init__(self, num_classes: int, depth: int = 50,
                 frozen_stages: int = -1):
        super().__init__()
        self.backbone = ResNet(depth, frozen_stages=frozen_stages)
        self.neck = FPN(in_channels=self.backbone.out_channels,
                        out_channels=256, num_outs=5, start_level=0,
                        add_extra_convs='')
        self.mask_feature_head = MaskFeatureHead()
        self.mask_head = SOLOV2HeadNet(num_classes)

    def forward(self, x):
        feats = self.neck(self.backbone(x))
        mask_feats = self.mask_feature_head(feats[:4])
        kernels, cls = self.mask_head(feats)
        return kernels, cls, mask_feats.float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init as erd_tpu's flax defaults: lecun-normal
        convs with zero biases (backbone, neck); the heads' ConvModules,
        ``conv_kernel`` and ``conv_cls`` N(0, 0.01); ``conv_cls``'s bias at
        the 0.01 prior."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for m in self.modules():
            if isinstance(m, Conv2d):
                normal(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
        for head in (self.mask_feature_head, self.mask_head):
            for m in head.modules():
                if isinstance(m, Conv2d):
                    normal(m.weight, 0.01)
        self.mask_head.conv_cls.bias.fill_(bias_init_prob(0.01))


def _crops(masks, boxes, stride, fh, fw, size):
    """erd_tpu's ``to_crop``: (B, D, size, size) bilinear samples of the
    (B, D, fh, fw) masks at a size x size grid of cell centres of each box
    (image units), clamped to the map."""
    t = (torch.arange(size, device=masks.device) + 0.5) / size
    cy = boxes[..., 1:2] + t * (boxes[..., 3:4] - boxes[..., 1:2])
    cx = boxes[..., 0:1] + t * (boxes[..., 2:3] - boxes[..., 0:1])
    fy = (cy / stride - 0.5).clamp(0, fh - 1)
    fx = (cx / stride - 0.5).clamp(0, fw - 1)
    y0, x0 = torch.floor(fy).long(), torch.floor(fx).long()
    wy, wx = (fy - y0)[..., :, None], (fx - x0)[..., None, :]
    y1, x1 = (y0 + 1).clamp(max=fh - 1), (x0 + 1).clamp(max=fw - 1)

    def at(yy, xx):  # m[yy][:, xx] of every (image, detection)
        idx = yy[..., :, None] * fw + xx[..., None, :]
        return torch.gather(masks.flatten(-2), -1, idx.flatten(-2)).view(
            idx.shape)
    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx +
            at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


@dataclass
class SOLOV2Detector:
    """Config + functions of SOLOv2."""
    num_classes: int = 80
    depth: int = 50
    compute_dtype: torch.dtype = torch.float32
    frozen_stages: int = 1
    nms_pre: int = 500
    score_thr: float = 0.1
    mask_thr: float = 0.5
    filter_thr: float = 0.05
    max_per_img: int = 100
    sigma: float = 2.0
    crop_size: int = 28
    preprocessor: Preprocessor = field(default_factory=Preprocessor)

    def __post_init__(self):
        if self.preprocessor.compute_dtype != self.compute_dtype:
            self.preprocessor = replace(self.preprocessor,
                                        compute_dtype=self.compute_dtype)

    def build_net(self) -> SOLOV2Net:
        return SOLOV2Net(self.num_classes, depth=self.depth,
                         frozen_stages=self.frozen_stages)

    def init(self, seed: int = 0, device=None) -> SOLOV2Net:
        """A seeded random network on ``device`` (``cuda`` unless the
        caller names one; raises without CUDA), in eval mode. The weights
        are drawn on the CPU, so a seed gives the same network anywhere."""
        net = self.build_net()
        net.init_weights(torch.Generator().manual_seed(seed))
        return net.to(resolve_device(device)).eval()

    @torch.no_grad()
    def forward_raw(self, net: SOLOV2Net, images: torch.Tensor):
        """erd_tpu's ``forward_raw``: (kernel predictions, class logits)
        per level NHWC float32, mask features (B, 256, H/4, W/4) float32."""
        return net(self.preprocessor(images))

    def loss(self, net, batch, **kwargs):
        raise NotImplementedError(f'SOLOv2 training is not ported yet '
                                  f'({TRAIN_ITEM}): the port serves SOLOv2')

    @torch.no_grad()
    def predict(self, net: SOLOV2Net, batch, rescale=True):
        """(DetResults, crops (B, max_per_img, 28, 28) mask probabilities)
        of (B, H, W, 3) uint8 canvases; boxes in the original image frame
        unless not ``rescale``."""
        images = batch['images']
        kernels_lvl, cls_lvl, mask_feats = self.forward_raw(net, images)
        return self.decode(kernels_lvl, cls_lvl, mask_feats,
                           images.shape[1], batch['meta'], rescale)

    @torch.no_grad()
    def decode(self, kernels_lvl, cls_lvl, mask_feats, canvas_h, meta,
               rescale=True):
        """erd_tpu's decode of the network's outputs (``predict`` after
        ``forward_raw``): ``dynamic_masks``, then ``select``."""
        cand = self.dynamic_masks(kernels_lvl, cls_lvl, mask_feats)
        return self.select(*cand, mask_feats.shape[-2:],
                           canvas_h / mask_feats.shape[-2], meta, rescale)

    def dynamic_masks(self, kernels_lvl, cls_lvl, mask_feats):
        """The top ``nms_pre`` cells over ``score_thr`` and their masks:
        (scores (B, k), labels (B, k), cell indices (B, k), mask
        probabilities (B, k, H/4 * W/4)), the dynamic 1x1 convs as one IEEE
        float32 product."""
        b = mask_feats.shape[0]
        kernels = torch.cat([k.reshape(b, -1, k.shape[-1])
                             for k in kernels_lvl], 1)
        cls = torch.cat([c.reshape(b, -1, self.num_classes)
                         for c in cls_lvl], 1)
        probs = torch.sigmoid(cls)
        best, lab = probs.max(-1)
        valid = best > self.score_thr
        k = min(self.nms_pre, best.shape[1])
        score, idx = topk_stable(torch.where(valid, best,
                                             torch.zeros_like(best)), k)
        pk = take_rows(kernels, idx)
        with matmul_fp32_precision('ieee'):
            mpred = torch.sigmoid(torch.matmul(pk, mask_feats.flatten(2)))
        return score, torch.gather(lab, 1, idx), idx, mpred

    def select(self, score, labk, idx, mpred, feat_hw, stride, meta,
               rescale=True):
        """Maskness, the mask-IoU matrix NMS (``matrix_decay``),
        ``filter_thr``, the top ``max_per_img``, boxes from the masks'
        extents (image units, then the original frame unless not
        ``rescale``) and their crops: (DetResults, crops)."""
        b, k = score.shape
        fh, fw = (int(v) for v in feat_hw)
        cell_strides = torch.from_numpy(np.concatenate([
            np.full(s * s, st, np.float32)
            for s, st in zip(NUM_GRIDS, GRID_STRIDES)])).to(score.device)
        binm = mpred > self.mask_thr
        area = binm.sum(-1).float()
        min_area = cell_strides[idx] / stride
        ok = (score > 0) & (area > min_area)
        maskness = torch.where(ok, (mpred * binm).sum(-1) /
                               area.clamp(min=1e-6), torch.zeros_like(area))
        score = score * maskness
        mflat = binm.float()
        with matmul_fp32_precision('ieee'):
            inter = torch.matmul(mflat, mflat.transpose(1, 2))
        union = area[:, :, None] + area[:, None, :] - inter
        miou = inter / union.clamp(min=1.0)
        score = matrix_decay(score, miou, labk, self.sigma, 'gaussian')
        keep = score > self.filter_thr
        fscore, sel = topk_stable(torch.where(keep, score,
                                              torch.zeros_like(score)),
                                  min(self.max_per_img, k))
        msel = take_rows(mpred, sel).view(b, -1, fh, fw)
        bsel = take_rows(binm, sel).view(b, -1, fh, fw)
        ys = (torch.arange(fh, dtype=torch.float32, device=score.device) +
              0.5) * stride
        xs = (torch.arange(fw, dtype=torch.float32, device=score.device) +
              0.5) * stride
        any_y, any_x = bsel.any(-1), bsel.any(-2)
        inf = torch.tensor(float('inf'), device=score.device)
        y1 = torch.where(any_y, ys, inf).amin(-1)
        y2 = torch.where(any_y, ys, -inf).amax(-1)
        x1 = torch.where(any_x, xs, inf).amin(-1)
        x2 = torch.where(any_x, xs, -inf).amax(-1)
        has = any_y.any(-1) & (fscore > 0)
        half = stride / 2
        boxes = torch.where(has[..., None], torch.stack(
            [x1 - half, y1 - half, x2 + half, y2 + half], -1),
            torch.zeros((), device=score.device))
        crops = _crops(msel, boxes, stride, fh, fw, self.crop_size)
        if rescale:
            boxes = scale_boxes(boxes, 1.0 / meta.scale_factor)
        return DetResults(bboxes=boxes, scores=fscore,
                          labels=torch.gather(labk, 1, sel), mask=has), crops
