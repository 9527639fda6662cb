"""GFL integral decoding: the plain ``integral`` and the fused candidate
decode ``integral_decode`` (kernel ``csrc/integral_decode.cu``).

``integral`` computes E[t] = sum_i softmax(logits)_i * i over the bins
{0..reg_max} of each box side, as erd_tpu/ops/integral.py does.
``integral_decode`` fuses what ``gfl_predict`` does with it for the top-k
candidate rows: integral, times the row's level stride, decode from the
anchor centre, clip to the image. The ERD distillation decodes its teacher
candidates with the same kernel, with unit strides and no clip.
"""
from __future__ import annotations

import ctypes

import torch

from ..structures.boxes import distance2bbox
from . import cuda_build


def integral(bbox_pred, reg_max=16):
    """(..., 4*(reg_max+1)) distribution logits -> (..., 4) distances."""
    shape = bbox_pred.shape
    x = bbox_pred.reshape(*shape[:-1], 4, reg_max + 1)
    p = torch.softmax(x, dim=-1)
    proj = torch.arange(reg_max + 1, dtype=p.dtype, device=p.device)
    return (p * proj).sum(dim=-1)


def integral_decode_plain(reg, rows, centers, strides, img_shape,
                          reg_max=16):
    """Plain PyTorch version of the decode kernel (same arguments)."""
    idx = rows.unsqueeze(-1).expand(-1, -1, reg.shape[-1])
    dist = integral(torch.gather(reg, 1, idx), reg_max) * \
        strides[rows].unsqueeze(-1)
    return distance2bbox(centers[rows], dist, max_shape=img_shape)


def integral_decode(reg, rows, centers, strides, img_shape, reg_max=16):
    """Decode the candidate rows of the flattened distribution logits.

    Args:
        reg: (B, N, 4*(reg_max+1)) fp32 logits, all levels flattened.
        rows: (B, K) int64 anchor rows in [0, N) to decode.
        centers: (N, 2) fp32 anchor centres.
        strides: (N,) fp32 level stride of each anchor.
        img_shape: (B, 2) fp32 per-image (H, W) to clip into, or None for
            no clip.
    Returns (B, K, 4) fp32 xyxy boxes.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch for the batch, counted in ``integral_decode.launches``).
    """
    b, n, c = reg.shape
    if c != 4 * (reg_max + 1):
        raise ValueError(f'reg has {c} channels, expected {4 * (reg_max + 1)}')
    if rows.dim() != 2 or rows.shape[0] != b:
        raise ValueError(f'rows must be (B, K), got {tuple(rows.shape)}')
    if tuple(centers.shape) != (n, 2) or tuple(strides.shape) != (n,) or \
            (img_shape is not None and tuple(img_shape.shape) != (b, 2)):
        raise ValueError('centers (N, 2), strides (N,), img_shape (B, 2) '
                         'expected')
    if reg.device.type == 'cpu':
        return integral_decode_plain(reg, rows, centers, strides, img_shape,
                                     reg_max)
    if reg.device.type != 'cuda':
        raise RuntimeError(f'integral_decode: no kernel for {reg.device}')
    floats = (reg, centers, strides) + (
        () if img_shape is None else (img_shape,))
    tensors = floats + (rows,)
    if any(t.device != reg.device for t in tensors):
        raise ValueError('integral_decode: all tensors must be on one device')
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError('integral_decode: reg, centers, strides and '
                        'img_shape must be float32')
    if rows.dtype != torch.int64:
        raise TypeError('integral_decode: rows must be int64')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('integral_decode: tensors must be contiguous')
    k = rows.shape[1]
    out = torch.empty((b, k, 4), dtype=torch.float32, device=reg.device)
    lib = cuda_build.load('integral_decode')
    fn = lib.erd_integral_decode
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(reg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(reg.data_ptr(), rows.data_ptr(), centers.data_ptr(),
                 strides.data_ptr(),
                 None if img_shape is None else img_shape.data_ptr(),
                 out.data_ptr(),
                 b, n, k, reg_max + 1, stream)
    cuda_build.check(lib, err, 'integral_decode')
    integral_decode.launches += 1
    return out


integral_decode.launches = 0
