"""Deformable convolution v1 / v2; the counterpart of
erd_tpu/ops/deform_conv.py.

A deformable convolution is a bilinear gather into columns (the im2col)
followed by one large matrix product with the weight. The gather is the
kernel ``csrc/deform_conv.cu`` (CUDA tensors; one launch per call, counted
in ``deform_im2col.launches``) or the plain version below (CPU tensors).
The product is ``torch.matmul`` in float32, as erd_tpu left its ``jnp.dot``
to XLA; a grouped convolution is one batched product.

Sampling rules of erd_tpu's ``_bilinear_zero``: kernel point k of output
pixel (i, j) samples at ``(i * stride - padding + ky * dilation + dy,
j * stride - padding + kx * dilation + dx)``; each of the four corners
counts only if its own integer index lies inside the map (0 otherwise); the
corners are weighted ``v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) +
v11*wy*wx``, left to right, and a DCNv2 mask multiplies the sum.

Layouts (NCHW, mmcv's): ``offset`` is (B, dg*K*K*2, Ho, Wo) with channels
ordered (deform group, kernel point, (dy, dx)), ``mask`` (B, dg*K*K, Ho,
Wo), both float32. The columns are (B, Cin*K*K, Ho*Wo) float32, row
``c * K*K + k``: channel-major, so ``weight (Cout, Cin*K*K) @ columns`` is
the NCHW output. erd_tpu flattens its patches (K*K, Cin) instead; the sums
of the product then run in another order.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import conv2d_ieee
from . import cuda_build

# channels of one deform group that one kernel thread gathers
CHANNELS_PER_THREAD = 16
NOT_TRAINED_YET = ('deformable convolution has no backward yet: DCN '
                   'training is not ported (ROADMAP.md, section 1)')
# arrange_offsets: conv_offset kernel std times fan_in^-1/2, and bias std
ARRANGE_WEIGHT_STD, ARRANGE_BIAS_STD = 0.02, 1.5


def _base_grid(ho, wo, k, stride, padding, dilation, device):
    """(K*K, Ho, 1) rows and (K*K, 1, Wo) columns of the sampling grid
    before the offsets, float32 (exact small integers)."""
    kidx = torch.arange(k * k, device=device)
    ky, kx = kidx // k, kidx % k
    by = (torch.arange(ho, device=device)[None, :] * stride - padding +
          ky[:, None] * dilation).float()
    bx = (torch.arange(wo, device=device)[None, :] * stride - padding +
          kx[:, None] * dilation).float()
    return by[:, :, None], bx[:, None, :]


def deform_im2col_plain(x, offset, mask, kernel_size, stride, padding,
                        dilation, deform_groups):
    """Plain PyTorch version of the kernel, erd_tpu's arithmetic op for op
    (bf16 maps are widened exactly to float32 before the weighting)."""
    b, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    kk, dg = kernel_size * kernel_size, deform_groups
    cpg = cin // dg
    by, bx = _base_grid(ho, wo, kernel_size, stride, padding, dilation,
                        x.device)
    off = offset.reshape(b, dg, kk, 2, ho, wo)
    ys = by + off[:, :, :, 0]  # (B, dg, K*K, Ho, Wo)
    xs = bx + off[:, :, :, 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0).reshape(b, dg, 1, kk * ho * wo)
    wx = (xs - x0).reshape(b, dg, 1, kk * ho * wo)
    y0i = y0.to(torch.int64).reshape(b, dg, 1, kk * ho * wo)
    x0i = x0.to(torch.int64).reshape(b, dg, 1, kk * ho * wo)
    planes = x.reshape(b, dg, cpg, h * w)

    def corner(yy, xx):  # (B, dg, cpg, K*K*Ho*Wo) float32, 0 off the map
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = torch.gather(planes, 3, idx.expand(b, dg, cpg, idx.shape[-1]))
        return torch.where(ok, v.float(), torch.zeros((), device=x.device))

    samp = (corner(y0i, x0i) * (1 - wy) * (1 - wx) +
            corner(y0i, x0i + 1) * (1 - wy) * wx +
            corner(y0i + 1, x0i) * wy * (1 - wx) +
            corner(y0i + 1, x0i + 1) * wy * wx)
    if mask is not None:
        samp = samp * mask.reshape(b, dg, 1, kk * ho * wo)
    return samp.reshape(b, cin * kk, ho * wo)


def _check(x, offset, mask, kernel_size, deform_groups):
    if x.dim() != 4 or offset.dim() != 4:
        raise ValueError('deform_im2col: x (B, Cin, H, W) and offset '
                         '(B, dg*K*K*2, Ho, Wo) expected')
    b, cin = x.shape[:2]
    kk, dg = kernel_size * kernel_size, deform_groups
    if cin % dg or offset.shape[0] != b or offset.shape[1] != dg * kk * 2:
        raise ValueError(f'deform_im2col: offset {tuple(offset.shape)} does '
                         f'not fit x {tuple(x.shape)} with {dg} deform '
                         f'groups of {kk} points')
    if mask is not None and tuple(mask.shape) != (b, dg * kk) + tuple(
            offset.shape[2:]):
        raise ValueError(f'deform_im2col: mask {tuple(mask.shape)} does not '
                         f'match the offset')


def deform_im2col(x, offset, mask, kernel_size: int = 3, stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  deform_groups: int = 1):
    """Deformable im2col.

    Args:
        x: (B, Cin, H, W) float32 or bfloat16.
        offset: (B, dg*K*K*2, Ho, Wo) float32 (dy, dx) per deform group and
            kernel point.
        mask: None (DCNv1) or (B, dg*K*K, Ho, Wo) float32 modulation,
            already through the sigmoid.
    Returns (B, Cin*K*K, Ho*Wo) float32 columns, row ``c * K*K + k``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Serving only: raises when an input needs a gradient.
    """
    _check(x, offset, mask, kernel_size, deform_groups)
    tensors = [t for t in (x, offset, mask) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(NOT_TRAINED_YET)
    if x.device.type == 'cpu':
        return deform_im2col_plain(x, offset, mask, kernel_size, stride,
                                   padding, dilation, deform_groups)
    if x.device.type != 'cuda':
        raise RuntimeError(f'deform_im2col: no kernel for {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            offset.dtype != torch.float32 or \
            (mask is not None and mask.dtype != torch.float32):
        raise TypeError('deform_im2col: x float32 or bfloat16, offset and '
                        'mask float32 expected')
    if any(t.device != x.device for t in tensors):
        raise ValueError('deform_im2col: all tensors must be on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('deform_im2col: tensors must be contiguous')
    b, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    kk = kernel_size * kernel_size
    cols = torch.empty((b, cin * kk, ho * wo), dtype=torch.float32,
                       device=x.device)
    lib = cuda_build.load('deform_conv')
    fn = lib.erd_deform_im2col
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), offset.data_ptr(),
                 None if mask is None else mask.data_ptr(), cols.data_ptr(),
                 b, cin, h, w, ho, wo, kernel_size, stride, padding,
                 dilation, deform_groups, CHANNELS_PER_THREAD,
                 int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'deform_im2col')
    deform_im2col.launches += 1
    return cols


deform_im2col.launches = 0


def deform_conv2d(x, offset, weight, mask=None, stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  deform_groups: int = 1, bias=None, conv_groups: int = 1):
    """Deformable convolution of a batch, NCHW.

    Args:
        x: (B, Cin, H, W) float32 or bfloat16.
        offset: (B, dg*K*K*2, Ho, Wo) float32; mask: None or (B, dg*K*K,
            Ho, Wo) float32 (see the module docstring).
        weight: (Cout, Cin // conv_groups, K, K), any float dtype; the
            product widens it to float32 (erd_tpu's promotion of bf16
            weights against float32 patches).
        bias: optional (Cout,), added in float32.
        conv_groups: torch Conv2d ``groups`` (ResNeXt's grouped 3x3).
    Returns (B, Cout, Ho, Wo) in x's dtype.
    """
    k = weight.shape[-1]
    b, cin = x.shape[:2]
    ho, wo = offset.shape[2:]
    cout, g = weight.shape[0], conv_groups
    if cin % g or cout % g or weight.shape[1] * g != cin:
        raise ValueError(f'deform_conv2d: weight {tuple(weight.shape)} does '
                         f'not fit {cin} input channels in {g} groups')
    cols = deform_im2col(x.contiguous(), offset.contiguous(),
                         None if mask is None else mask.contiguous(), k,
                         stride, padding, dilation, deform_groups)
    w = weight.float().reshape(g, cout // g, (cin // g) * k * k)
    out = torch.matmul(w, cols.view(b, g, (cin // g) * k * k, ho * wo))
    out = out.reshape(b, cout, ho, wo)
    if bias is not None:
        out = out + bias.float()[:, None, None]
    return out.to(x.dtype)


class DeformConv2d(nn.Module):
    """A 3x3, stride-1 deformable convolution whose offsets come from
    outside (VFNet's star offsets): ``weight`` (Cout, Cin, 3, 3), no bias,
    no mask; mmcv's DeformConv2d state-dict name. The weight is rounded to
    the input's dtype (erd_tpu casts its parameters to the compute dtype)
    and the product runs in float32."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))

    def forward(self, x, offset):
        return deform_conv2d(x, offset, self.weight.to(x.dtype))


class ModulatedDeformConv(nn.Module):
    """The ResNet DCN plugin's 3x3: DCNv2 (or DCNv1 with
    ``modulated=False``), one deform group, no bias. A 3x3 ``conv_offset``
    predicts the offsets, and for DCNv2 the mask logits, then the
    deformable convolution with ``weight``.

    ``conv_offset``'s output channels are erd_tpu's (K*K, per_point)
    layout: interleaved (dy, dx, mask_logit) triples for DCNv2, (dy, dx)
    pairs for DCNv1 (mmcv's DCNv1 layout; mmcv's DCNv2 puts the masks after
    all the pairs instead). bf16 numerics of erd_tpu: ``conv_offset`` is a
    float32 convolution of the widened input with its parameters rounded to
    the input's dtype; the sampling is float32 and the product float32 with
    the weight rounded likewise; the output is cast back to the input's
    dtype.
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 modulated: bool = True):
        super().__init__()
        self.stride, self.modulated = stride, modulated
        self.conv_offset = nn.Conv2d(in_ch, 9 * (3 if modulated else 2), 3,
                                     stride=stride, padding=1)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """erd_tpu's init: zero ``conv_offset`` (the module starts as a
        plain convolution, mask sigmoid(0) = 0.5), he-normal ``weight``."""
        fan_in = self.weight[0].numel()
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator)
                          * (2.0 / fan_in) ** 0.5)
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()

    def offsets(self, x):
        """(offset (B, 18, Ho, Wo), mask (B, 9, Ho, Wo) or None) from
        ``conv_offset``, both float32."""
        c = self.conv_offset
        off = conv2d_ieee(x.float(), c.weight.to(x.dtype).float(),
                          c.bias.to(x.dtype).float(), c.stride, c.padding)
        if not self.modulated:
            return off, None
        b, _, ho, wo = off.shape
        off = off.view(b, 9, 3, ho, wo)
        return (off[:, :, :2].reshape(b, 18, ho, wo),
                torch.sigmoid(off[:, :, 2]))

    def forward(self, x):
        offset, mask = self.offsets(x)
        return deform_conv2d(x, offset, self.weight.to(x.dtype), mask,
                             self.stride)


def arrange_offsets(net: nn.Module, seed: int) -> None:
    """Seeded non-zero ``conv_offset`` weights of every ModulatedDeformConv
    in ``net``, for checks: erd_tpu's zero init samples every point on an
    integer pixel with mask 0.5, so the interpolation, the zero padding and
    the modulation would go unchecked. In module order, the kernel gets
    N(0, (ARRANGE_WEIGHT_STD / sqrt(fan_in))^2) and the bias
    N(0, ARRANGE_BIAS_STD^2), from ``np.random.RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ModulatedDeformConv):
                c = m.conv_offset
                fan_in = c.weight[0].numel()
                w = rs.normal(0.0, ARRANGE_WEIGHT_STD / fan_in ** 0.5,
                              tuple(c.weight.shape))
                bias = rs.normal(0.0, ARRANGE_BIAS_STD, tuple(c.bias.shape))
                c.weight.copy_(torch.from_numpy(w.astype(np.float32)))
                c.bias.copy_(torch.from_numpy(bias.astype(np.float32)))
