"""FPN with CARAFE top-down upsampling (NCHW); the counterpart of
erd_tpu/models/necks/pyramid_extras.py ``FPNCARAFE``.

Lateral 1x1 convs from ``start_level`` on; then, from the top level down,
each lateral is upsampled x2 by a ``CARAFEPack`` (the kernel
``csrc/carafe.cu`` on the card), cropped to the next lateral's size (CARAFE
doubles exactly, so odd sizes need the crop) and added to it in the compute
dtype; then the 3x3 output convs, and extra levels by a 1x1 stride-2 max
pool (every second row and column), as erd_tpu does.

Module names follow mmdet's FPN_CARAFE: ``lateral_convs.{i}.conv``,
``upsample_modules.{i-1}`` (the CARAFEPack that upsamples lateral i) and
``fpn_convs.{j}.conv``. mmdet's extra levels are stride-2 convs with their
own upsample modules; erd_tpu's are the max pool, which has no weights.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...ops.carafe import CARAFEPack
from ..layers import ConvModule


class FPNCARAFE(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.start_level = start_level
        self.num_outs = num_outs
        used = range(start_level, len(in_channels))
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i], out_channels, 1, gn=False, act=False)
            for i in used)
        self.upsample_modules = nn.ModuleList(
            CARAFEPack(out_channels, up_factor=2) for _ in list(used)[1:])
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, gn=False, act=False)
            for _ in used)

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        laterals = [conv(inputs[self.start_level + i])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = self.upsample_modules[i - 1](laterals[i])
            th, tw = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[..., :th, :tw]
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][..., ::2, ::2])
        return tuple(outs)
