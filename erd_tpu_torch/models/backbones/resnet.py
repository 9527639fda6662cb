"""ResNet backbone (NCHW, frozen BN); the counterpart of
erd_tpu/models/backbones/resnet.py for depths 18 to 152, with the
deformable-convolution plugin (``dcn_stages``).

'pytorch'-style blocks (stride on the 3x3 conv), a 7x7/2 stem conv and a
3x3/2 max-pool, four stages returning (C2..C5). Module names follow the
torchvision / mmdet state-dict keys (``conv1``, ``bn1``,
``layerK.i.convJ``, ``layerK.i.downsample.{0,1}``; a DCN block's
``layerK.i.conv2.weight`` and ``layerK.i.conv2.conv_offset.*``). The stem
is the plain 7x7/2 conv: erd_tpu's space-to-depth stem is a TPU lowering of
the same linear map.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import ModulatedDeformConv
from ..layers import Conv2d, FrozenBatchNorm, max_pool_torch

ARCH_SETTINGS = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}


def _downsample(in_ch, out_ch, stride):
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                         FrozenBatchNorm(out_ch))


class Bottleneck(nn.Module):
    """``dcn=True`` swaps the 3x3 for a deformable convolution, modulated
    (DCNv2) or not (DCNv1): the reference's dcn stage plugin."""
    expansion = 4

    def __init__(self, in_ch, planes, stride=1, downsample=False, dcn=False,
                 dcn_modulated=True):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = ModulatedDeformConv(
            planes, planes, stride=stride, modulated=dcn_modulated) \
            if dcn else Conv2d(planes, planes, 3, stride=stride, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = _downsample(in_ch, out_ch, stride) \
            if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, stride=stride, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = _downsample(in_ch, planes, stride) \
            if downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """``frozen_stages`` >= 0 freezes the stem, and >= s also layer1..s
    (``requires_grad=False``, the reference's ``_freeze_stages``): autograd
    then computes no gradient below the last frozen stage, as erd_tpu's
    stop_gradient at that boundary does.

    ``dcn_stages[s]`` puts the deformable 3x3 (``dcn_modulated``: DCNv2 or
    DCNv1) into every block of stage s, bottleneck blocks only (erd_tpu's
    rule: basic blocks ignore it)."""

    def __init__(self, depth: int = 50, frozen_stages: int = -1,
                 dcn_stages=(False, False, False, False),
                 dcn_modulated: bool = True):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise ValueError(f'ResNet depth {depth} is not ported '
                             f'(supported: {sorted(ARCH_SETTINGS)})')
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = Bottleneck if block_type == 'bottleneck' else BasicBlock
        self.conv1 = Conv2d(3, 64, 7, stride=2, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch, planes = 64, 64
        self.out_channels = []
        for stage, num_blocks in enumerate(stage_blocks):
            blocks = []
            for b in range(num_blocks):
                stride = 2 if b == 0 and stage > 0 else 1
                needs_ds = b == 0 and (
                    stride != 1 or in_ch != planes * block_cls.expansion)
                dcn = dict(dcn=True, dcn_modulated=dcn_modulated) if \
                    dcn_stages[stage] and block_cls is Bottleneck else {}
                blocks.append(block_cls(in_ch, planes, stride=stride,
                                        downsample=needs_ds, **dcn))
                in_ch = planes * block_cls.expansion
            self.add_module(f'layer{stage + 1}', nn.Sequential(*blocks))
            self.out_channels.append(in_ch)
            planes *= 2
        frozen = [self.conv1, self.bn1] if frozen_stages >= 0 else []
        frozen += [getattr(self, f'layer{s}')
                   for s in range(1, frozen_stages + 1)]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_torch(x, 3, 2, 1)
        outs = []
        for stage in range(4):
            x = getattr(self, f'layer{stage + 1}')(x)
            outs.append(x)
        return tuple(outs)
