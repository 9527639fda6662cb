"""CARAFE content-aware upsampling; the counterpart of erd_tpu/ops/carafe.py.

``CARAFEPack`` predicts a reassembly kernel for every output pixel (a 1x1
``channel_compressor`` to 64 channels, then a 3x3 ``content_encoder`` to
up^2 * k_up^2 logits, both in the compute dtype) and ``carafe`` applies
them: erd_tpu's pixel shuffle, a float32 softmax over the k_up^2 taps, and
the reassembly, where output pixel (i, j) is the softmax-weighted sum of the
zero-padded k_up x k_up neighbourhood of source pixel (i // up, j // up),
per channel, in float32 on the widened map, cast back to the map's dtype.

erd_tpu's channel order: logit channel ``(a * up + b) * k_up^2 + k`` is tap
k of sub-pixel (a, b), not ``F.pixel_shuffle``'s ``k * up^2 + a * up + b``
(nor mmcv's). Maps are NCHW here; erd_tpu's are NHWC.

For CUDA tensors ``carafe`` is the kernel ``csrc/carafe.cu`` (one launch per
call, counted in ``carafe.launches``); for CPU tensors it is
``carafe_plain``. ``carafe`` is an autograd Function: its gradients in the
map and the logits are ``carafe_backward``, the backward kernel of the same
file or its plain version ``carafe_backward_plain``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_build
from .roi_align import acc_dtype

# the kernel's fixed geometry: x2 upsampling, 5x5 reassembly kernels
KERNEL_UP, KERNEL_K_UP = 2, 5
# arrange_carafe: content_encoder kernel std times fan_in^-1/2, and bias std
ARRANGE_WEIGHT_STD, ARRANGE_BIAS_STD = 0.5, 2.5


def carafe_weights(logits, up: int = 2, k_up: int = 5):
    """(B, up^2 * k_up^2, H, W) logits -> (B, k_up^2, H*up, W*up) float32
    (float64 for float64 logits) reassembly weights: erd_tpu's pixel
    shuffle, then jax.nn.softmax's arithmetic exp(x - max) / sum over the
    taps, the sum taken in tap order as the kernel takes it."""
    b, _, h, w = logits.shape
    kk = k_up * k_up
    lg = logits.to(acc_dtype(logits.dtype)).view(b, up, up, kk, h, w)
    lg = lg.permute(0, 3, 4, 1, 5, 2)
    lg = lg.reshape(b, kk, h * up, w * up)
    e = torch.exp(lg - lg.amax(1, keepdim=True))
    total = e[:, :1]
    for k in range(1, kk):
        total = total + e[:, k:k + 1]
    return e / total


def carafe_plain(x, logits, up: int = 2, k_up: int = 5):
    """Plain PyTorch version of the kernel: x (B, C, H, W) float32 or bf16,
    logits (B, up^2 * k_up^2, H, W) -> (B, C, H*up, W*up) in x's dtype. The
    taps are summed in order k = 0 .. k_up^2 - 1, each product and sum
    rounded to float32 (float64 for float64 inputs)."""
    b, c, h, w = x.shape
    kk, pad = k_up * k_up, (k_up - 1) // 2
    wk = carafe_weights(logits, up, k_up).view(b, kk, h, up, w, up)
    xp = F.pad(x.to(acc_dtype(x.dtype)), (pad, pad, pad, pad))
    acc = None
    for k in range(kk):
        ky, kx = divmod(k, k_up)
        v = xp[:, :, ky:ky + h, kx:kx + w][:, :, :, None, :, None]
        term = wk[:, k:k + 1] * v  # (B, C, H, up, W, up)
        acc = term if acc is None else acc + term
    return acc.reshape(b, c, h * up, w * up).to(x.dtype)


def _check(x, logits, up, k_up):
    if x.dim() != 4 or logits.dim() != 4 or \
            logits.shape[0] != x.shape[0] or \
            logits.shape[1] != up * up * k_up * k_up or \
            logits.shape[2:] != x.shape[2:]:
        raise ValueError(f'carafe: logits {tuple(logits.shape)} do not fit x '
                         f'{tuple(x.shape)} with up={up}, k_up={k_up}')


def _check_cuda(what, x, logits, up, k_up, *others):
    """The kernels' argument rules: up = 2, k_up = 5, one CUDA device, x
    float32 or bfloat16 and every other tensor of its dtype, contiguous."""
    if x.device.type != 'cuda':
        raise RuntimeError(f'{what}: no kernel for {x.device}')
    if (up, k_up) != (KERNEL_UP, KERNEL_K_UP):
        raise ValueError(f'{what}: the kernel takes up={KERNEL_UP}, '
                         f'k_up={KERNEL_K_UP}, got {up}, {k_up}')
    tensors = (x, logits) + others
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f'{what}: x float32 or bfloat16, the other tensors '
                        f'of the same dtype expected')
    if any(t.device != x.device for t in tensors):
        raise ValueError(f'{what}: all tensors must be on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{what}: tensors must be contiguous')


def _carafe_kernel(x, logits, up, k_up):
    """Launch ``erd_carafe`` (CUDA tensors); counted in
    ``carafe.launches``."""
    _check_cuda('carafe', x, logits, up, k_up)
    b, c, h, w = x.shape
    out = torch.empty((b, c, h * up, w * up), dtype=x.dtype, device=x.device)
    lib = cuda_build.load('carafe')
    fn = lib.erd_carafe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), logits.data_ptr(), out.data_ptr(), b, c, h, w,
                 sms, int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'carafe')
    carafe.launches += 1
    return out


class _CARAFE(torch.autograd.Function):
    """CARAFE with its gradients in ``x`` and ``logits`` by
    ``carafe_backward``: the kernel for CUDA tensors, the plain version for
    CPU tensors."""

    @staticmethod
    def forward(ctx, x, logits, up, k_up):
        ctx.save_for_backward(x, logits)
        ctx.geometry = (up, k_up)
        if x.device.type == 'cpu':
            return carafe_plain(x, logits, up, k_up)
        return _carafe_kernel(x, logits, up, k_up)

    @staticmethod
    def backward(ctx, grad):
        x, logits = ctx.saved_tensors
        dx, dlogits = carafe_backward(x, logits, grad.contiguous(),
                                      *ctx.geometry)
        return dx, dlogits, None, None


def carafe(x, logits, up: int = 2, k_up: int = 5):
    """CARAFE reassembly with its kernel prediction's pixel shuffle and
    softmax.

    Args:
        x: (B, C, H, W) float32 or bfloat16 map.
        logits: (B, up^2 * k_up^2, H, W) content-encoder logits, x's dtype.
    Returns (B, C, H*up, W*up) in x's dtype, differentiable in ``x`` and
    ``logits`` (``carafe_backward``).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes up = 2 and k_up = 5 (CARAFEPack's defaults) and raises on
    other sizes.
    """
    _check(x, logits, up, k_up)
    if x.device.type not in ('cpu', 'cuda'):
        raise RuntimeError(f'carafe: no kernel for {x.device}')
    return _CARAFE.apply(x, logits, up, k_up)


carafe.launches = 0


def carafe_backward_plain(x, logits, grad, up: int = 2, k_up: int = 5):
    """Plain PyTorch version of the backward kernel, written out in
    float32 (not autograd of ``carafe_plain``): with w the softmax weights
    and g the widened output gradient,
    dw[k, p] = sum_c g[c, p] * xpad[c, tap k of p],
    dxpad[c, tap k of p] += w[k, p] * g[c, p] (taps k = 0..24 in order, the
    up^2 output pixels of a source pixel summed together),
    dlogit = w * (dw - sum_k w * dw) (the float32 softmax's backward),
    scattered back to erd_tpu's channel order (a * up + b) * k_up^2 + k.
    Returns (dx, dlogits), each rounded once to its input's dtype."""
    b, c, h, w = x.shape
    kk, pad = k_up * k_up, (k_up - 1) // 2
    wk = carafe_weights(logits, up, k_up).view(b, kk, h, up, w, up)
    g = grad.to(acc_dtype(grad.dtype)).view(b, c, h, up, w, up)
    xp = F.pad(x.to(g.dtype), (pad, pad, pad, pad))
    dxp = torch.zeros_like(xp)
    dw = torch.empty_like(wk)
    for k in range(kk):
        ky, kx = divmod(k, k_up)
        v = xp[:, :, ky:ky + h, kx:kx + w][:, :, :, None, :, None]
        dw[:, k] = (g * v).sum(1)
        dxp[:, :, ky:ky + h, kx:kx + w] += (g * wk[:, k:k + 1]).sum((3, 5))
    dlg = wk * (dw - (wk * dw).sum(1, keepdim=True))
    dlogits = dlg.permute(0, 3, 5, 1, 2, 4).reshape(b, up * up * kk, h, w)
    return (dxp[:, :, pad:pad + h, pad:pad + w].to(x.dtype),
            dlogits.to(logits.dtype))


def carafe_backward(x, logits, grad, up: int = 2, k_up: int = 5):
    """Gradients of ``carafe`` in ``x`` and ``logits``.

    Args:
        x, logits: as ``carafe`` took them.
        grad: (B, C, H*up, W*up) output gradient in x's dtype.
    Returns (dx (B, C, H, W) in x's dtype, dlogits (B, up^2 * k_up^2, H, W)
    in the logits' dtype).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``erd_carafe_backward`` (its dlogits and dx launches, one call counted
    in ``carafe_backward.launches``), which takes up = 2 and k_up = 5.
    """
    _check(x, logits, up, k_up)
    b, c, h, w = x.shape
    if tuple(grad.shape) != (b, c, h * up, w * up):
        raise ValueError(f'carafe_backward: grad {tuple(grad.shape)} does not '
                         f'fit x {tuple(x.shape)}')
    if x.device.type == 'cpu':
        return carafe_backward_plain(x, logits, grad, up, k_up)
    _check_cuda('carafe_backward', x, logits, up, k_up, grad)
    if any(t.data_ptr() % 16 for t in (x, logits, grad)):
        raise ValueError('carafe_backward: the kernel copies aligned element '
                         'pairs; x, logits and grad must start 16-byte '
                         'aligned')
    dx = torch.empty_like(x)
    dlogits = torch.empty_like(logits)
    lib = cuda_build.load('carafe')
    fn = lib.erd_carafe_backward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), logits.data_ptr(), grad.data_ptr(),
                 dx.data_ptr(), dlogits.data_ptr(), b, c, h, w, sms,
                 int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'carafe_backward')
    carafe_backward.launches += 1
    return dx, dlogits


carafe_backward.launches = 0


class CARAFEPack(nn.Module):
    """Kernel prediction + reassembly, mmcv's CARAFEPack names
    (``channel_compressor``, ``content_encoder``); both convs compute in
    the input's dtype."""

    def __init__(self, channels: int, up_factor: int = 2, up_kernel: int = 5,
                 encoder_kernel: int = 3, compressed_channels: int = 64):
        # imported here: erd_tpu_torch.models imports this package
        from ..models.layers import Conv2d
        super().__init__()
        self.up_factor, self.up_kernel = up_factor, up_kernel
        self.channel_compressor = Conv2d(channels, compressed_channels, 1)
        self.content_encoder = Conv2d(
            compressed_channels, up_factor ** 2 * up_kernel ** 2,
            encoder_kernel)

    def forward(self, x):
        logits = self.content_encoder(self.channel_compressor(x))
        return carafe(x.contiguous(), logits.contiguous(), self.up_factor,
                      self.up_kernel)


def arrange_carafe(net: nn.Module, seed: int) -> None:
    """Seeded ``content_encoder`` weights of every CARAFEPack in ``net``,
    for checks: erd_tpu's N(0, 0.001) init gives every tap a weight near
    1/25, which would hide a wrong tap or sub-pixel order. In module order,
    the kernel gets N(0, (ARRANGE_WEIGHT_STD / sqrt(fan_in))^2) and the bias
    N(0, ARRANGE_BIAS_STD^2), from ``np.random.RandomState(seed)``: the
    bias makes the four sub-pixel kernels differ and peak, the kernel makes
    them depend on the content."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, CARAFEPack):
                c = m.content_encoder
                fan_in = c.weight[0].numel()
                w = rs.normal(0.0, ARRANGE_WEIGHT_STD / fan_in ** 0.5,
                              tuple(c.weight.shape))
                bias = rs.normal(0.0, ARRANGE_BIAS_STD, tuple(c.bias.shape))
                c.weight.copy_(torch.from_numpy(w.astype(np.float32)))
                c.bias.copy_(torch.from_numpy(bias.astype(np.float32)))
