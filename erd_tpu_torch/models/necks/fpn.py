"""Feature Pyramid Network neck (NCHW); the counterpart of
erd_tpu/models/necks/fpn.py for the GFL configuration: lateral 1x1 convs,
top-down nearest sum, 3x3 output convs, and extra stride-2 convs on the last
output (``add_extra_convs='on_output'``, no ReLU between them).

Module names follow mmdet: ``lateral_convs.{i}.conv`` and
``fpn_convs.{j}.conv``, where the extra convs come after the output convs.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ..layers import ConvModule, nearest_upsample_to


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 1):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.start_level = start_level
        used = range(start_level, len(in_channels))
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i], out_channels, 1, gn=False, act=False)
            for i in used)
        n_extra = num_outs - len(self.lateral_convs)
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, gn=False, act=False)
             for _ in used] +
            [ConvModule(out_channels, out_channels, 3, stride=2, gn=False,
                        act=False) for _ in range(n_extra)])

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        laterals = [conv(inputs[self.start_level + i])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nearest_upsample_to(
                laterals[i], laterals[i - 1].shape[-2:])
        n = len(laterals)
        outs = [self.fpn_convs[j](laterals[j]) for j in range(n)]
        for conv in self.fpn_convs[n:]:
            outs.append(conv(outs[-1]))
        return tuple(outs)
