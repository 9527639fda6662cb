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
``carafe_plain``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_build

# channels of one image that one kernel thread reassembles
CHANNELS_PER_THREAD = 16
# the kernel's fixed geometry: x2 upsampling, 5x5 reassembly kernels
KERNEL_UP, KERNEL_K_UP = 2, 5
# arrange_carafe: content_encoder kernel std times fan_in^-1/2, and bias std
ARRANGE_WEIGHT_STD, ARRANGE_BIAS_STD = 0.5, 2.5


def carafe_weights(logits, up: int = 2, k_up: int = 5):
    """(B, up^2 * k_up^2, H, W) logits -> (B, k_up^2, H*up, W*up) float32
    reassembly weights: erd_tpu's pixel shuffle, then jax.nn.softmax's
    arithmetic exp(x - max) / sum over the taps, the sum taken in tap order
    as the kernel takes it."""
    b, _, h, w = logits.shape
    kk = k_up * k_up
    lg = logits.float().view(b, up, up, kk, h, w).permute(0, 3, 4, 1, 5, 2)
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
    rounded to float32."""
    b, c, h, w = x.shape
    kk, pad = k_up * k_up, (k_up - 1) // 2
    wk = carafe_weights(logits, up, k_up).view(b, kk, h, up, w, up)
    xp = F.pad(x.float(), (pad, pad, pad, pad))
    acc = None
    for k in range(kk):
        ky, kx = divmod(k, k_up)
        v = xp[:, :, ky:ky + h, kx:kx + w][:, :, :, None, :, None]
        term = wk[:, k:k + 1] * v  # (B, C, H, up, W, up)
        acc = term if acc is None else acc + term
    return acc.reshape(b, c, h * up, w * up).to(x.dtype)


def carafe(x, logits, up: int = 2, k_up: int = 5):
    """CARAFE reassembly with its kernel prediction's pixel shuffle and
    softmax.

    Args:
        x: (B, C, H, W) float32 or bfloat16 map.
        logits: (B, up^2 * k_up^2, H, W) content-encoder logits, x's dtype.
    Returns (B, C, H*up, W*up) in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes up = 2 and k_up = 5 (CARAFEPack's defaults) and raises on
    other sizes.
    """
    if x.dim() != 4 or logits.dim() != 4 or \
            logits.shape[0] != x.shape[0] or \
            logits.shape[1] != up * up * k_up * k_up or \
            logits.shape[2:] != x.shape[2:]:
        raise ValueError(f'carafe: logits {tuple(logits.shape)} do not fit x '
                         f'{tuple(x.shape)} with up={up}, k_up={k_up}')
    if x.device.type == 'cpu':
        return carafe_plain(x, logits, up, k_up)
    if x.device.type != 'cuda':
        raise RuntimeError(f'carafe: no kernel for {x.device}')
    if (up, k_up) != (KERNEL_UP, KERNEL_K_UP):
        raise ValueError(f'carafe: the kernel takes up={KERNEL_UP}, '
                         f'k_up={KERNEL_K_UP}, got {up}, {k_up}')
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            logits.dtype != x.dtype:
        raise TypeError('carafe: x float32 or bfloat16, logits of the same '
                        'dtype expected')
    if logits.device != x.device:
        raise ValueError('carafe: all tensors must be on one device')
    if not (x.is_contiguous() and logits.is_contiguous()):
        raise ValueError('carafe: tensors must be contiguous')
    b, c, h, w = x.shape
    out = torch.empty((b, c, h * up, w * up), dtype=x.dtype, device=x.device)
    lib = cuda_build.load('carafe')
    fn = lib.erd_carafe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), logits.data_ptr(), out.data_ptr(), b, c, h, w,
                 CHANNELS_PER_THREAD, int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'carafe')
    carafe.launches += 1
    return out


carafe.launches = 0


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
