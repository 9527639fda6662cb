"""Small helpers shared by the port's entry points."""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F


@contextmanager
def conv_fp32_precision(precision: str = 'ieee'):
    """cuDNN's float32 convolution precision inside the block: ``'ieee'``
    (full float32) or ``'tf32'``; the previous setting comes back on exit.

    torch lets cuDNN convolve float32 in TF32 by default (about three
    decimal digits), while erd_tpu's float32 convolutions are full float32,
    so the port's float32 convs run under ``'ieee'``. torch >= 2.9 reads
    ``cudnn.conv.fp32_precision``; older versions read the legacy
    ``cudnn.allow_tf32``, and only the one that is read is set.
    ``cudnn.flags(allow_tf32=False)`` would also switch cuDNN off.
    """
    if precision not in ('ieee', 'tf32'):
        raise ValueError(f"precision must be 'ieee' or 'tf32', got "
                         f'{precision!r}')
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, 'conv', None)
    if conv is not None and hasattr(conv, 'fp32_precision'):
        saved = conv.fp32_precision
        conv.fp32_precision = precision
        try:
            yield
        finally:
            conv.fp32_precision = saved
    else:
        saved = cudnn.allow_tf32
        cudnn.allow_tf32 = precision == 'tf32'
        try:
            yield
        finally:
            cudnn.allow_tf32 = saved


class _IEEEConv2d(torch.autograd.Function):
    """A 2-D convolution, or transposed convolution, whose forward and
    backward (cuDNN's data and weight gradients) both run under
    ``conv_fp32_precision('ieee')``: autograd runs a plain convolution's
    backward outside any context the forward was called in."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, transposed):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, bias is not None, transposed)
        conv = F.conv_transpose2d if transposed else F.conv2d
        with conv_fp32_precision('ieee'):
            return conv(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, has_bias, transposed = ctx.conv
        need = ctx.needs_input_grad
        out_ch = weight.shape[1] if transposed else weight.shape[0]
        with conv_fp32_precision('ieee'):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [out_ch] if has_bias else None,
                stride, padding, (1, 1), transposed, (0, 0), 1,
                (need[0], need[1], has_bias and need[2]))
        return gx, gw, gb, None, None, None


def conv2d_ieee(x, weight, bias=None, stride=(1, 1), padding=(0, 0)):
    """F.conv2d (dilation 1, one group) in full float32, forward and
    backward; for float32 tensors, where cuDNN may otherwise use TF32."""
    return _IEEEConv2d.apply(x, weight, bias, tuple(stride), tuple(padding),
                             False)


def conv_transpose2d_ieee(x, weight, bias=None, stride=(1, 1),
                          padding=(0, 0)):
    """F.conv_transpose2d (no output padding, dilation 1, one group) in
    full float32, forward and backward."""
    return _IEEEConv2d.apply(x, weight, bias, tuple(stride), tuple(padding),
                             True)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the port '
                'on the CPU')
        return torch.device('cuda')
    return torch.device(device)
