"""Deformable convolution v1 / v2; the counterpart of
erd_tpu/ops/deform_conv.py.

A deformable convolution is a bilinear gather into columns (the im2col)
followed by one large matrix product with the weight. The gather is the
kernel ``csrc/deform_conv.cu`` (CUDA tensors; one launch per call, counted
in ``deform_im2col.launches``) or the plain version below (CPU tensors).
The product is ``torch.matmul`` in float32, as erd_tpu left its ``jnp.dot``
to XLA; a grouped convolution is one batched product, and its weight
gradient is that product's autograd.

``deform_im2col`` is an autograd Function: its gradients in the map, the
offsets and the masks are ``deform_im2col_backward``, the backward kernel
of the same file (``erd_deform_im2col_backward``, counted in
``deform_im2col_backward.launches``) or its plain version, the transpose of
erd_tpu's gathers written out.

Sampling rules of erd_tpu's ``_bilinear_zero``: kernel point k of output
pixel (i, j) samples at ``(i * stride - padding + ky * dilation + dy,
j * stride - padding + kx * dilation + dx)``; each of the four corners
counts only if its own integer index lies inside the map (0 otherwise); the
corners are weighted ``v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) +
v11*wy*wx``, left to right, and a DCNv2 mask multiplies the sum. floor's
derivative is 0, so the offsets' gradient is that of the fractions alone.

Layouts (NCHW, mmcv's): ``offset`` is (B, dg*K*K*2, Ho, Wo) with channels
ordered (deform group, kernel point, (dy, dx)), ``mask`` (B, dg*K*K, Ho,
Wo), both float32. The columns are (B, Cin*K*K, Ho*Wo) float32, row
``c * K*K + k``: channel-major, so ``weight (Cout, Cin*K*K) @ columns`` is
the NCHW output. erd_tpu flattens its patches (K*K, Cin) instead; the sums
of the product then run in another order. float64 inputs of
``deform_im2col`` on the CPU give float64 columns and gradients
(finite-difference checks).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from ..utils import conv2d_ieee
from . import cuda_build
from .roi_align import acc_dtype

# channels of one deform group that one forward kernel thread gathers
CHANNELS_PER_THREAD = 16
# the backward kernel's plan (``deform_backward_chunk``): its threads a
# block; a call of ONE_CHUNK_BLOCKS blocks an SM or more keeps the group's
# channels in one chunk, the others take chunks of SPLIT_CHUNK (measured
# on an H100, erd_tpu_torch/tools/atomic_backward_probe.py)
BACKWARD_THREADS = 256
ONE_CHUNK_BLOCKS, SPLIT_CHUNK = 16, 64
SM_COUNT = 132  # an H100 SXM
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


def _samples(offset, kernel_size, stride, padding, dilation, deform_groups,
             acc):
    """Per (image, group, 1, K*K*Ho*Wo) sample: the top-left corner's
    integer row and column, and the fractions wy, wx (in ``acc``)."""
    b, _, ho, wo = offset.shape
    kk, dg = kernel_size * kernel_size, deform_groups
    by, bx = _base_grid(ho, wo, kernel_size, stride, padding, dilation,
                        offset.device)
    off = offset.to(acc).reshape(b, dg, kk, 2, ho, wo)
    ys = by.to(acc) + off[:, :, :, 0]  # (B, dg, K*K, Ho, Wo)
    xs = bx.to(acc) + off[:, :, :, 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    shape = (b, dg, 1, kk * ho * wo)
    return (y0.to(torch.int64).reshape(shape),
            x0.to(torch.int64).reshape(shape),
            (ys - y0).reshape(shape), (xs - x0).reshape(shape))


def _corner(planes, h, w, yy, xx):
    """The corner (yy, xx) of every sample, read from ``planes`` (B, dg,
    cpg, H*W) and 0 where it lies off the map; with its flat index and
    whether it lies on the map."""
    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
    v = torch.gather(planes, 3, idx.expand(*planes.shape[:3], idx.shape[-1]))
    return torch.where(ok, v, torch.zeros((), dtype=v.dtype,
                                          device=v.device)), idx, ok


def deform_im2col_plain(x, offset, mask, kernel_size, stride, padding,
                        dilation, deform_groups):
    """Plain PyTorch version of the kernel, erd_tpu's arithmetic op for op
    (bf16 maps are widened exactly to float32 before the weighting)."""
    b, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    kk, dg = kernel_size * kernel_size, deform_groups
    acc = acc_dtype(torch.promote_types(x.dtype, offset.dtype))
    y0, x0, wy, wx = _samples(offset, kernel_size, stride, padding, dilation,
                              dg, acc)
    planes = x.to(acc).reshape(b, dg, cin // dg, h * w)
    samp = (_corner(planes, h, w, y0, x0)[0] * (1 - wy) * (1 - wx) +
            _corner(planes, h, w, y0, x0 + 1)[0] * (1 - wy) * wx +
            _corner(planes, h, w, y0 + 1, x0)[0] * wy * (1 - wx) +
            _corner(planes, h, w, y0 + 1, x0 + 1)[0] * wy * wx)
    if mask is not None:
        samp = samp * mask.to(acc).reshape(b, dg, 1, kk * ho * wo)
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


def _check_cuda(what, x, offset, mask, extra=()):
    """The kernels' input rules: float32 or bf16 maps; float32 offsets,
    masks and gradients; one device; contiguous."""
    tensors = [t for t in (x, offset, mask) + tuple(extra) if t is not None]
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError(f'{what}: x float32 or bfloat16, offset, mask and '
                        f'gradients float32 expected')
    if any(t.device != x.device for t in tensors):
        raise ValueError(f'{what}: all tensors must be on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{what}: tensors must be contiguous')


def _forward_kernel(x, offset, mask, kernel_size, stride, padding, dilation,
                    deform_groups):
    _check_cuda('deform_im2col', x, offset, mask)
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


class _DeformIm2col(torch.autograd.Function):
    """The deformable im2col with its gradients in the map, the offsets
    and the masks (``deform_im2col_backward``), computing only those that
    autograd asks for; the samples are recomputed, not stored."""

    @staticmethod
    def forward(ctx, x, offset, mask, geometry):
        ctx.save_for_backward(x, offset, mask)
        ctx.geometry = geometry
        if x.device.type == 'cpu':
            return deform_im2col_plain(x, offset, mask, *geometry)
        return _forward_kernel(x, offset, mask, *geometry)

    @staticmethod
    def backward(ctx, grad):
        x, offset, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx, goff, gmask = deform_im2col_backward(
            x, offset, mask, grad.contiguous(), *ctx.geometry, need[0],
            need[1] or need[2])
        return (gx, goff if need[1] else None, gmask if need[2] else None,
                None)


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
    Returns (B, Cin*K*K, Ho*Wo) float32 columns, row ``c * K*K + k``,
    differentiable in x, the offsets and the masks
    (``deform_im2col_backward``).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check(x, offset, mask, kernel_size, deform_groups)
    if x.device.type not in ('cpu', 'cuda'):
        raise RuntimeError(f'deform_im2col: no kernel for {x.device}')
    return _DeformIm2col.apply(x, offset, mask, (
        int(kernel_size), int(stride), int(padding), int(dilation),
        int(deform_groups)))


deform_im2col.launches = 0


def deform_im2col_backward_plain(x, offset, mask, grad, kernel_size, stride,
                                 padding, dilation, deform_groups,
                                 need_x=True, need_offset=True):
    """Plain PyTorch version of the backward kernel: the gradients (x (B,
    Cin, H, W), offset (B, dg*K*K*2, Ho, Wo), mask (B, dg*K*K, Ho, Wo) or
    None for DCNv1) of ``deform_im2col_plain`` for the column gradient
    ``grad`` (B, Cin*K*K, Ho*Wo), in float32 (float64 for float64 inputs);
    None for a gradient not asked for.

    Per sample, with a channel's column gradient G, the mask m (1 for
    DCNv1), the fractions wy, wx, hy = 1 - wy, hx = 1 - wx and the corner
    values v (0 off the map): each on-map corner of x gets ((G*m)*hx)*hy,
    ((G*m)*wx)*hy, ((G*m)*hx)*wy or ((G*m)*wx)*wy (``index_add_``); dy gets
    m * sum_c G*((v10 - v00)*hx + (v11 - v01)*wx), dx m * sum_c G*((v01 -
    v00)*hy + (v11 - v10)*wy), the mask sum_c G * sample. One image at a
    time, so that the temporaries stay an image's size."""
    b, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    kk, dg = kernel_size * kernel_size, deform_groups
    cpg, n = cin // dg, kk * ho * wo
    acc = acc_dtype(torch.promote_types(x.dtype, offset.dtype))
    gx = torch.zeros((b, dg, cpg, h * w), dtype=acc, device=x.device) \
        if need_x else None
    goff = torch.zeros((b, dg, kk, 2, ho * wo), dtype=acc,
                       device=x.device) if need_offset else None
    gmask = torch.zeros((b, dg, n), dtype=acc, device=x.device) \
        if need_offset and mask is not None else None
    for i in range(b):
        y0, x0, wy, wx = _samples(offset[i:i + 1], kernel_size, stride,
                                  padding, dilation, dg, acc)
        hy, hx = 1 - wy, 1 - wx
        planes = x[i:i + 1].to(acc).reshape(1, dg, cpg, h * w)
        g = grad[i:i + 1].to(acc).reshape(1, dg, cpg, n)
        m = None if mask is None else \
            mask[i:i + 1].to(acc).reshape(1, dg, 1, n)
        gm = g if m is None else g * m
        corners = {}
        for dy, cy in ((0, hy), (1, wy)):
            for dx, cx in ((0, hx), (1, wx)):
                v, idx, ok = _corner(planes, h, w, y0 + dy, x0 + dx)
                corners[dy, dx] = v
                if need_x:
                    contrib = gm * cx * cy
                    for j in range(dg):
                        on = ok[0, j, 0]
                        gx[i, j].index_add_(1, idx[0, j, 0][on],
                                            contrib[0, j][:, on])
        if not need_offset:
            continue
        v00, v01 = corners[0, 0], corners[0, 1]
        v10, v11 = corners[1, 0], corners[1, 1]
        sy = (g * ((v10 - v00) * hx + (v11 - v01) * wx)).sum(2)
        sx = (g * ((v01 - v00) * hy + (v11 - v10) * wy)).sum(2)
        if m is not None:
            sy, sx = sy * m[:, :, 0], sx * m[:, :, 0]
            samp = v00 * hy * hx + v01 * hy * wx + v10 * wy * hx + \
                v11 * wy * wx
            gmask[i] = (g * samp).sum(2)[0]
        goff[i, :, :, 0] = sy[0].reshape(dg, kk, ho * wo)
        goff[i, :, :, 1] = sx[0].reshape(dg, kk, ho * wo)
    return (None if gx is None else gx.reshape(b, cin, h, w),
            None if goff is None else goff.reshape(b, dg * kk * 2, ho, wo),
            None if gmask is None else gmask.reshape(b, dg * kk, ho, wo))


def deform_backward_chunk(batch, cin, deform_groups, kernel_size, ho, wo,
                          sms=SM_COUNT) -> int:
    """The channels of a deform group that one map-gradient thread of
    ``erd_deform_im2col_backward`` takes, from the call's shape (pure
    Python): all of them (one walk over the channels gives both
    gradients) when the call's samples fill the card ONE_CHUNK_BLOCKS
    times over; else SPLIT_CHUNK, and the offset and mask gradients take
    blocks of their own, for the parallelism that small maps lack."""
    cpg = cin // deform_groups
    blocks = -(-batch * deform_groups * kernel_size * kernel_size * ho * wo
               // BACKWARD_THREADS)
    return cpg if blocks >= ONE_CHUNK_BLOCKS * sms else min(SPLIT_CHUNK,
                                                             cpg)


def _backward_launch(x, offset, mask, grad, kernel_size, stride, padding,
                     dilation, deform_groups, need_x, need_offset, chunk):
    """One launch of ``erd_deform_im2col_backward`` with map-gradient
    threads of ``chunk`` channels (CUDA tensors, checked by the caller)."""
    b, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    dev = x.device
    gx = torch.zeros((b, cin, h, w), dtype=torch.float32, device=dev) \
        if need_x else None
    goff = torch.empty(offset.shape, dtype=torch.float32, device=dev) \
        if need_offset else None
    gmask = torch.empty(mask.shape, dtype=torch.float32, device=dev) \
        if need_offset and mask is not None else None
    lib = cuda_build.load('deform_conv')
    fn = lib.erd_deform_im2col_backward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), offset.data_ptr(), ptr(mask), grad.data_ptr(),
                 ptr(gx), ptr(goff), ptr(gmask), b, cin, h, w, ho, wo,
                 kernel_size, stride, padding, dilation, deform_groups,
                 int(x.dtype == torch.bfloat16), chunk, stream)
    cuda_build.check(lib, err, 'deform_im2col_backward')
    return gx, goff, gmask


def deform_im2col_backward(x, offset, mask, grad, kernel_size: int = 3,
                           stride: int = 1, padding: int = 1,
                           dilation: int = 1, deform_groups: int = 1,
                           need_x: bool = True, need_offset: bool = True):
    """Gradients of ``deform_im2col`` for the column gradient ``grad`` (B,
    Cin*K*K, Ho*Wo) float32: (d x in x's dtype, d offset float32, d mask
    float32, or None for DCNv1). ``need_x`` / ``need_offset`` False skip
    the map's, or the offsets' and masks' gradients (None in their place).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``erd_deform_im2col_backward`` on ``deform_backward_chunk``'s plan (one
    launch per call, counted in ``deform_im2col_backward.launches``), or
    raise. Its map gradient is float32 atomics into a zeroed buffer, each
    warp's adds to shared corners combined first, rounded once to x's
    dtype: not deterministic. Its offset and mask gradients sum the
    channels in order: deterministic.
    """
    _check(x, offset, mask, kernel_size, deform_groups)
    b, cin = x.shape[:2]
    ho, wo = offset.shape[2:]
    kk = kernel_size * kernel_size
    if tuple(grad.shape) != (b, cin * kk, ho * wo):
        raise ValueError('deform_im2col_backward: grad must be (B, Cin*K*K, '
                         'Ho*Wo)')
    if x.device.type == 'cpu':
        gx, goff, gmask = deform_im2col_backward_plain(
            x, offset, mask, grad, kernel_size, stride, padding, dilation,
            deform_groups, need_x, need_offset)
        return (None if gx is None else gx.to(x.dtype), goff, gmask)
    if x.device.type != 'cuda':
        raise RuntimeError(f'deform_im2col_backward: no kernel for '
                           f'{x.device}')
    _check_cuda('deform_im2col_backward', x, offset, mask, (grad,))
    if not (need_x or need_offset):
        return None, None, None
    chunk = deform_backward_chunk(
        b, cin, deform_groups, kernel_size, ho, wo,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    gx, goff, gmask = _backward_launch(
        x, offset, mask, grad, kernel_size, stride, padding, dilation,
        deform_groups, need_x, need_offset, chunk)
    deform_im2col_backward.launches += 1
    return (None if gx is None else gx.to(x.dtype), goff, gmask)


deform_im2col_backward.launches = 0


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
