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

from ..utils import conv2d_ieee


def _cast(p: Optional[torch.Tensor], x: torch.Tensor):
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input's dtype, torch padding k // 2; a
    float32 input convolves in full float32 (no TF32), forward and
    backward, as erd_tpu's do.

    With ``param_dtype``, the parameters are rounded to it and the conv
    runs in the promoted dtype of the input and ``param_dtype``, as
    ``Linear`` does: the mask heads of a bf16 model convolve their float32
    RoI features with bf16-rounded weights in float32.
    """

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, bias=True,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=bias)
        self.param_dtype = param_dtype

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.param_dtype is not None:
            x = x.to(torch.promote_types(x.dtype, self.param_dtype))
            w, b = w.to(self.param_dtype), _cast(b, w.to(self.param_dtype))
        w, b = w.to(x.dtype), _cast(b, x)
        if x.dtype != torch.float32:
            return self._conv_forward(x, w, b)
        return conv2d_ieee(x, w, b, self.stride, self.padding)


class Linear(nn.Linear):
    """nn.Linear whose parameters are rounded to ``param_dtype`` and then
    computed in the promoted dtype of the input and ``param_dtype``.

    erd_tpu casts every parameter to the compute dtype at apply time, and
    flax's Dense promotes a float32 input against bf16 parameters to
    float32: the R-CNN and DETR heads of a bf16 model run float32 products
    of bf16-rounded weights, and a bf16 input stays bf16. ``param_dtype``
    float32 is a plain linear layer.
    """

    def __init__(self, in_features, out_features,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.param_dtype = param_dtype

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.param_dtype)
        return F.linear(x.to(dtype),
                        self.weight.to(self.param_dtype).to(dtype),
                        self.bias.to(self.param_dtype).to(dtype))


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last dim: epsilon 1e-6 (flax's
    default; torch's is 1e-5), statistics in float32 with flax's fast
    variance max(0, E[x^2] - E[x]^2), and the result in the promoted dtype
    of the input and ``param_dtype``."""

    def __init__(self, features: int, eps: float = 1e-6,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.param_dtype = param_dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp(min=0)
        mul = torch.rsqrt(var + self.eps) * \
            self.weight.to(self.param_dtype).float()
        y = (x32 - mu) * mul + self.bias.to(self.param_dtype).float()
        return y.to(torch.promote_types(x.dtype, self.param_dtype))


def softmax(x, dim: int = -1):
    """jax.nn.softmax's formula, exp(x - max) / sum, each op in x's dtype
    (bf16 in erd_tpu's bf16 query paths)."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


class MultiheadAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention (0.12) without dropout.

    ``query``, ``key`` and ``value`` project (C -> heads x hd), ``out``
    (heads x hd -> C), each a ``Linear`` in its input's promoted dtype; q,
    k and v are promoted to one dtype, the query is divided by sqrt(hd)
    before the product, a mask (True = attend, broadcast to (B, heads, Q,
    K)) fills with that dtype's finfo.min, and the softmax is
    jax.nn.softmax's. Plain ``torch.matmul``: XLA computed it outside any
    TPU formulation.
    """

    def __init__(self, embed_dim: int, num_heads: int,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(embed_dim, embed_dim, param_dtype)
        self.key = Linear(embed_dim, embed_dim, param_dtype)
        self.value = Linear(embed_dim, embed_dim, param_dtype)
        self.out = Linear(embed_dim, embed_dim, param_dtype)

    def forward(self, inputs_q, inputs_k, inputs_v, mask=None):
        b, nq, c = inputs_q.shape
        hd = c // self.num_heads
        q, k, v = (proj(x).reshape(b, x.shape[1], self.num_heads, hd)
                   .transpose(1, 2)
                   for proj, x in ((self.query, inputs_q),
                                   (self.key, inputs_k),
                                   (self.value, inputs_v)))
        dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                    v.dtype)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        depth = torch.sqrt(torch.full((), float(hd), device=q.device))
        w = torch.matmul(q / depth.to(dtype), k.transpose(-1, -2))
        if mask is not None:
            w = torch.where(mask, w, torch.finfo(dtype).min)
        y = torch.matmul(softmax(w), v).transpose(1, 2).reshape(b, nq, c)
        return self.out(y)


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
                 gn: bool = True, act: bool = True,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           bias=not gn, param_dtype=param_dtype)
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
