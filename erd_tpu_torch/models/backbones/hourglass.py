"""HourglassNet backbone (CornerNet), NCHW, float32; the counterpart of
erd_tpu/models/backbones/hourglass.py.

Stem: a 7x7/2 conv-BN-ReLU to 128 channels and a stride-2 BasicBlock to
256; then ``num_stacks`` recursive hourglass modules (``downsample_times``
levels with ``stage_channels`` / ``stage_blocks``), each followed by a 3x3
out-conv; between stacks the remix inter = block(relu(bn(conv(inter)) +
bn(conv(out)))). HourglassNet-104 is 2 stacks, channels (256, 256, 384,
384, 384, 512) and blocks (2, 2, 2, 2, 2, 4). Returns one stride-4 feature
per stack.

Modules carry erd_tpu's scope names (``stem_conv.conv``, ``stem_conv.bn``,
``hourglass0.low2.low2.up1.block0.conv1``, ...), so ``params_from_jax``
maps a path by joining it. ``BatchNorm`` is flax's ``BatchNorm(momentum=0.9,
epsilon=1e-5)``: in eval mode it reads the running statistics; in train
mode (``module.train()``, as CornerNet's loss runs it) it normalises by the
batch statistics and updates the running ones in place. erd_tpu's float32
network, so every conv runs in full float32. A canvas's
sides must be multiples of 4 * 2^downsample_times (128 for HG-104): the
nearest x2 upsample of each level must meet the level above it.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, FrozenBatchNorm


class BatchNorm(FrozenBatchNorm):
    """flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW maps.

    Eval mode: the running statistics (``FrozenBatchNorm``'s arithmetic).
    Train mode: the batch mean and biased variance over (N, H, W), y = (x -
    mean) * (rsqrt(var + eps) * weight) + bias with gradients through both
    statistics, and the running statistics updated in place as 0.9 * old +
    0.1 * batch with the biased variance (``torch.nn.BatchNorm2d`` would
    store the unbiased one). The variance is the mean of the squared
    deviations: flax writes the same statistic as max(0, E[x^2] - E[x]^2),
    but its XLA-compiled gradient lands within 2e-5 of this form's, while
    autograd of E[x^2] - E[x]^2 in float32 cancels and drifts ~1e-4 from
    both (tests/test_torch_cornernet_train.py)."""

    momentum = 0.9

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        centred = xf - mean[:, None, None]
        var = (centred * centred).mean((0, 2, 3))
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(
                (1 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_(
                (1 - self.momentum) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = centred * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Conv (no bias, padding k // 2) -> BN -> optional ReLU; erd_tpu's
    ``_ConvBN``."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, act=True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride=stride, bias=False)
        self.bn = BatchNorm(out_ch)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    def __init__(self, in_ch, out_ch, stride=1):
        super().__init__()
        self.conv1 = ConvBN(in_ch, out_ch, 3, stride)
        self.conv2 = ConvBN(out_ch, out_ch, 3, act=False)
        self.downsample = ConvBN(in_ch, out_ch, 1, stride, act=False) \
            if stride != 1 or in_ch != out_ch else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class ResLayer(nn.Module):
    """``num_blocks`` BasicBlocks named ``block{i}``, the first strided."""

    def __init__(self, in_ch, out_ch, num_blocks, stride=1):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'block{i}', BasicBlock(
                in_ch if i == 0 else out_ch, out_ch, stride if i == 0 else 1))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f'block{i}')(x)
        return x


class HourglassModule(nn.Module):
    """up1 (same size) + nearest x2 of low3(low2(low1 (stride 2)))."""

    def __init__(self, depth: int, in_ch: int, stage_channels: Sequence[int],
                 stage_blocks: Sequence[int]):
        super().__init__()
        cur_ch, next_ch = stage_channels[0], stage_channels[1]
        cur_bl, next_bl = stage_blocks[0], stage_blocks[1]
        self.up1 = ResLayer(in_ch, cur_ch, cur_bl)
        self.low1 = ResLayer(in_ch, next_ch, cur_bl, stride=2)
        self.low2 = HourglassModule(depth - 1, next_ch, stage_channels[1:],
                                    stage_blocks[1:]) if depth > 1 else \
            ResLayer(next_ch, next_ch, next_bl)
        self.low3 = ResLayer(next_ch, cur_ch, cur_bl)

    def forward(self, x):
        up1 = self.up1(x)
        low3 = self.low3(self.low2(self.low1(x)))
        up2 = low3.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        if up2.shape[-2:] != up1.shape[-2:]:
            raise ValueError(
                f'HourglassNet: a level of {tuple(x.shape[-2:])} comes back '
                f'as {tuple(up2.shape[-2:])}; the canvas sides must be '
                f'multiples of 4 * 2^downsample_times')
        return up1 + up2


class HourglassNet(nn.Module):
    def __init__(self, downsample_times: int = 5, num_stacks: int = 2,
                 stage_channels: Sequence[int] = (256, 256, 384, 384, 384,
                                                  512),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 feat_channel: int = 256):
        super().__init__()
        self.num_stacks = num_stacks
        cur_ch = stage_channels[0]
        self.stem_conv = ConvBN(3, cur_ch // 2, 7, 2)
        self.stem_block = BasicBlock(cur_ch // 2, cur_ch, stride=2)
        for i in range(num_stacks):
            self.add_module(f'hourglass{i}', HourglassModule(
                downsample_times, cur_ch, stage_channels, stage_blocks))
            self.add_module(f'out_conv{i}', ConvBN(cur_ch, feat_channel, 3))
            if i < num_stacks - 1:
                self.add_module(f'remix_inter{i}',
                                ConvBN(cur_ch, cur_ch, 1, act=False))
                self.add_module(f'remix_out{i}',
                                ConvBN(feat_channel, cur_ch, 1, act=False))
                self.add_module(f'inter_block{i}', ResLayer(cur_ch, cur_ch, 1))

    def forward(self, x) -> list:
        return list(self.stacks(x))

    def stacks(self, x):
        """The features of the stacks one at a time (a generator), so a
        caller that needs only the last one can drop the others."""
        inter = self.stem_block(self.stem_conv(x))
        for i in range(self.num_stacks):
            out = getattr(self, f'out_conv{i}')(
                getattr(self, f'hourglass{i}')(inter))
            yield out
            if i < self.num_stacks - 1:
                inter = getattr(self, f'inter_block{i}')(F.relu(
                    getattr(self, f'remix_inter{i}')(inter) +
                    getattr(self, f'remix_out{i}')(out)))
