"""ChannelMapper neck (NCHW); the counterpart of erd_tpu/models/necks/
extra_necks.py ``ChannelMapper`` as the DETR family builds it.

Each input level goes through a conv (``conv_i``, kernel 1 in the DETR
configs) and GroupNorm(32) (``gn_i``); each extra level is a 3x3/2 conv
(``extra_conv_k``) and GroupNorm (``extra_gn_k``) on the RAW last input for
the first one, on the previous extra output after it. The norms use flax's
epsilon 1e-6, not the 1e-5 of ``layers.ConvModule``. Module names are
erd_tpu's scopes.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ..layers import Conv2d, GroupNorm


class ChannelMapper(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, kernel_size: int = 1,
                 num_outs: int = 4, num_groups: int = 32):
        super().__init__()
        self.num_in = len(in_channels)
        self.num_extra = num_outs - self.num_in
        groups = min(num_groups, out_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f'conv_{i}', Conv2d(c, out_channels, kernel_size))
            self.add_module(f'gn_{i}', GroupNorm(groups, out_channels,
                                                 eps=1e-6))
        src = in_channels[-1]
        for k in range(self.num_extra):
            self.add_module(f'extra_conv_{k}',
                            Conv2d(src, out_channels, 3, stride=2))
            self.add_module(f'extra_gn_{k}', GroupNorm(groups, out_channels,
                                                       eps=1e-6))
            src = out_channels

    def forward(self, inputs):
        if len(inputs) != self.num_in:
            raise ValueError(f'ChannelMapper takes {self.num_in} levels, '
                             f'got {len(inputs)}')
        outs = [getattr(self, f'gn_{i}')(getattr(self, f'conv_{i}')(x))
                for i, x in enumerate(inputs)]
        src = inputs[-1]
        for k in range(self.num_extra):
            src = getattr(self, f'extra_gn_{k}')(
                getattr(self, f'extra_conv_{k}')(src))
            outs.append(src)
        return tuple(outs)
