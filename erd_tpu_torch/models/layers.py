"""NN building blocks (NCHW); the counterpart of erd_tpu/models/layers.py.

Parameters stay float32 and every layer casts them to its input's dtype at
use, which mirrors erd_tpu's ``cast_compute_params``: a bf16 network runs
bf16 convolutions while the frozen-BN statistics stay float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p: Optional[torch.Tensor], x: torch.Tensor):
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input's dtype, torch padding k // 2."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, bias=True):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=bias)

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x))


class Linear(nn.Linear):
    """nn.Linear whose parameters are rounded to ``param_dtype`` and then
    computed in the input's dtype.

    erd_tpu casts every parameter to the compute dtype at apply time, and
    flax's Dense promotes a float32 input against bf16 parameters to
    float32: the R-CNN head of a bf16 model runs float32 products of
    bf16-rounded weights. ``param_dtype`` float32 is a plain linear layer.
    """

    def __init__(self, in_features, out_features,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.param_dtype = param_dtype

    def forward(self, x):
        return F.linear(x, self.weight.to(self.param_dtype).to(x.dtype),
                        self.bias.to(self.param_dtype).to(x.dtype))


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics (reference norm_eval=True).

    ``weight``/``bias`` are parameters and ``running_mean``/``running_var``
    buffers, as in torch's BatchNorm2d, so mmdet checkpoints load by name.
    The folded scale and shift are computed in float32 from the statistics
    and cast to the input dtype, as erd_tpu's FrozenBatchNorm does.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        scale = self.weight.to(x.dtype).float()
        bias = self.bias.to(x.dtype).float()
        r = torch.rsqrt(self.running_var + self.eps)
        inv = (r * scale).to(x.dtype)
        shift = (bias - self.running_mean * r * scale).to(x.dtype)
        return torch.addcmul(shift[:, None, None], x, inv[:, None, None])


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm computing in the input's dtype."""

    def forward(self, x):
        return F.group_norm(x, self.num_groups, _cast(self.weight, x),
                            _cast(self.bias, x), self.eps)


class Scale(nn.Module):
    """Learnable scalar multiplier (per-FPN-level reg scale in GFL)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


class ConvModule(nn.Module):
    """Conv + optional GroupNorm(32) + optional ReLU.

    Submodule names follow mmcv's ConvModule (``conv``, ``gn``) so mmdet
    state-dict keys load as they are. The norm absorbs the bias.
    """

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1,
                 gn: bool = True, act: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           bias=not gn)
        self.gn = GroupNorm(32, out_ch, eps=1e-5) if gn else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.gn is not None:
            x = self.gn(x)
        return F.relu(x) if self.act else x


def max_pool_torch(x, window: int, stride: int, padding: int):
    """torch MaxPool2d with symmetric padding (pads with -inf)."""
    return F.max_pool2d(x, window, stride, padding)


def nearest_upsample_to(x, out_hw: Tuple[int, int]):
    """Nearest resize of (B, C, H, W) with erd_tpu's explicit index rule:
    output index i reads floor(i * (in / out)) computed in float32."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    idx_h = torch.floor(torch.arange(oh, dtype=torch.float32,
                                     device=x.device) * (h / oh)).long()
    idx_w = torch.floor(torch.arange(ow, dtype=torch.float32,
                                     device=x.device) * (w / ow)).long()
    return x[..., idx_h[:, None], idx_w[None, :]]


def bias_init_prob(prior_prob: float) -> float:
    """Focal-style bias value: sigmoid(bias) == prior_prob."""
    return -math.log((1 - prior_prob) / prior_prob)
