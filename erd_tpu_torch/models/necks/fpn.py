"""Feature Pyramid Network neck (NCHW); the counterpart of
erd_tpu/models/necks/fpn.py: lateral 1x1 convs from ``start_level`` on,
top-down nearest sum, 3x3 output convs, then the extra levels:
- ``add_extra_convs='on_output'`` (GFL): stride-2 3x3 convs on the last
  output, no ReLU between them;
- ``add_extra_convs=''`` (Faster R-CNN): ``max_pool(1x1, stride 2)`` of the
  last output, i.e. every second row and column.

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
                 start_level: int = 1, add_extra_convs: str = 'on_output'):
        super().__init__()
        if add_extra_convs not in ('', 'on_output'):
            raise NotImplementedError(
                f'FPN add_extra_convs={add_extra_convs!r} is not ported yet')
        self.in_channels = tuple(in_channels)
        self.start_level = start_level
        self.num_outs = num_outs
        used = range(start_level, len(in_channels))
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i], out_channels, 1, gn=False, act=False)
            for i in used)
        n_extra = num_outs - len(self.lateral_convs) if add_extra_convs \
            else 0
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
        while len(outs) < self.num_outs:
            outs.append(outs[-1][..., ::2, ::2])
        return tuple(outs)
