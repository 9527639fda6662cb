"""Mask heads and the mask loss; the counterparts of erd_tpu/models/heads/
mask_head.py ``FCNMaskHead`` and of point_rend.py's ``CoarseMaskHead`` and
``MaskPointHead``.

Every layer rounds its weights to the model's compute dtype
(``param_dtype``) and runs in the promoted dtype of its input: the heads
take float32 RoI features and point features, so a bf16 model computes
float32 products of bf16-rounded weights, as flax does in erd_tpu. The
float32 convolutions run in full float32 (no TF32).

``FCNMaskHead`` carries mmdet's names (``convs.i.conv``, ``upsample``,
``conv_logits``). erd_tpu's ``ConvTranspose`` kernel (2, 2, I, O) is not
flipped (flax's ``transpose_kernel=False``), so output pixel (2i + a, 2j +
b) takes tap (1 - a, 1 - b) of it; ``weight_import.params_from_jax`` flips
the taps into torch's ``ConvTranspose2d`` layout (I, O, 2, 2), where it
takes tap (a, b). ``mask_loss`` is erd_tpu's ``mask_loss``: the BCE of each
positive RoI's target-class logits against its targets.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...losses import binary_cross_entropy_with_logits
from ...utils import conv_transpose2d_ieee
from ..layers import Conv2d, ConvModule, Linear


def pick_class(logits, labels):
    """(R, C, H, W) logits, (R,) labels -> (R, H, W) of each RoI's class
    (labels clipped into range, as erd_tpu's)."""
    r, c = logits.shape[:2]
    idx = labels.reshape(-1).long().clamp(0, c - 1)
    return logits[torch.arange(r, device=logits.device), idx]


def mask_loss(mask_logits, mask_targets, labels, is_pos):
    """BCE on the target-class channel of the positive RoIs: mask_logits
    (R, C, S, S) float32, mask_targets (R, S, S) in [0, 1], labels (R,),
    is_pos (R,). Each RoI's mean over its S x S cells, summed over the
    positives and divided by max(#positives, 1)."""
    bce = binary_cross_entropy_with_logits(pick_class(mask_logits, labels),
                                           mask_targets)
    pos = is_pos.reshape(-1).to(bce.dtype)
    return (bce.mean((1, 2)) * pos).sum() / pos.sum().clamp(min=1.0)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """The 2x2 stride-2 transposed conv of the mask head, weights rounded
    to ``param_dtype``, computed in the promoted dtype (full float32 for a
    float32 input, forward and backward)."""

    def __init__(self, in_ch, out_ch, param_dtype=torch.float32):
        super().__init__(in_ch, out_ch, 2, stride=2)
        self.param_dtype = param_dtype

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.param_dtype)
        w = self.weight.to(self.param_dtype).to(dtype)
        b = self.bias.to(self.param_dtype).to(dtype)
        return conv_transpose2d_ieee(x.to(dtype), w, b, stride=(2, 2))


class FCNMaskHead(nn.Module):
    """4 conv3x3 256 + ReLU, the 2x upsample + ReLU, a 1x1 ``conv_logits``:
    (R, 256, 14, 14) -> (R, C, 28, 28) mask logits."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_convs: int = 4, feat_channels: int = 256,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else feat_channels,
                       feat_channels, 3, gn=False, param_dtype=param_dtype)
            for i in range(num_convs)])
        self.upsample = ConvTranspose2x2(feat_channels, feat_channels,
                                         param_dtype)
        self.conv_logits = Conv2d(feat_channels, num_classes, 1,
                                  param_dtype=param_dtype)

    def forward(self, roi_feats):
        x = roi_feats
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(F.relu(self.upsample(x)))


class CoarseMaskHead(nn.Module):
    """PointRend's coarse head: 4 conv3x3 256 + ReLU (``convs.i``), two fc
    1024 + ReLU (``fcs.i``) and ``fc_logits`` to 14 x 14 x C logits:
    (R, 256, 14, 14) -> (R, C, 14, 14).

    ``fcs.0`` takes the channel-major (C, 14, 14) flatten (its rows are
    permuted from erd_tpu's (14, 14, C) on import, as the bbox head's);
    ``fc_logits`` keeps erd_tpu's (14, 14, C) output order, so the result
    is a channels-last view with the NCHW shape.
    """

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_channels: int = 256, fc_channels: int = 1024,
                 out_size: int = 14,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_size = out_size
        self.convs = nn.ModuleList([
            Conv2d(in_channels if i == 0 else conv_channels, conv_channels,
                   3, param_dtype=param_dtype) for i in range(4)])
        self.fcs = nn.ModuleList([
            Linear(conv_channels * out_size ** 2, fc_channels, param_dtype),
            Linear(fc_channels, fc_channels, param_dtype)])
        self.fc_logits = Linear(fc_channels,
                                out_size ** 2 * num_classes, param_dtype)

    def forward(self, roi_feats):
        x = roi_feats
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.flatten(1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        s = self.out_size
        return self.fc_logits(x).reshape(x.shape[0], s, s, -1).permute(
            0, 3, 1, 2)


class MaskPointHead(nn.Module):
    """PointRend's point head: ``fcs.i`` (256 + ReLU) over [fine point
    features, coarse point logits], the coarse logits concatenated again
    after each, then ``fc_logits``: fine (R, K, 256), coarse (R, K, C) ->
    (R, K, C) point logits."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_fcs: int = 3, channels: int = 256,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fcs = nn.ModuleList([
            Linear((in_channels if i == 0 else channels) + num_classes,
                   channels, param_dtype) for i in range(num_fcs)])
        self.fc_logits = Linear(channels + num_classes, num_classes,
                                param_dtype)

    def forward(self, fine_feats, coarse_logits):
        x = torch.cat([fine_feats, coarse_logits], -1)
        for fc in self.fcs:
            x = torch.cat([F.relu(fc(x)), coarse_logits], -1)
        return self.fc_logits(x)
