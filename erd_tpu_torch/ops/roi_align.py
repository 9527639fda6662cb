"""Multi-level RoIAlign; the counterpart of erd_tpu/ops/roi_align.py.

``aligned=True`` RoIAlign (mmcv's semantics as erd_tpu reproduces them):
each of the out x out bins of an RoI averages ``sampling_ratio``^2 bilinear
samples at its regular sub-grid, after scaling the RoI to the level and
subtracting 0.5. Samples outside [-1, H] x [-1, W] are 0; inside, the
coordinates clamp at 0, and at the last row or column the sample takes that
row (its weight on the next one is 0).

Each RoI is sampled on one FPN level, chosen by ``map_roi_levels`` (mmdet's
finest-scale rule). erd_tpu computes all levels and selects with a one-hot
sum, which gives the same numbers, since x * 1 + 0 + 0 + 0 == x. The level
map is computed once, in torch, by ``multilevel_roi_align``, and the same
(B, R) tensor goes to the kernel (``csrc/roi_align.cu``, CUDA tensors) or to
the plain version below (CPU tensors).

Layout: features are the port's NCHW level maps; the output is (B, R, C,
out, out), the order mmdet's bbox head flattens (erd_tpu's is (R, out, out,
C); ``weight_import`` permutes the first fc's rows accordingly).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_build


def _div(a, d):
    """a / d, rounded as IEEE division on every device: PyTorch's CUDA
    kernels multiply by the reciprocal of a Python-scalar divisor."""
    return a / torch.full_like(a, d)


def map_roi_levels(rois, num_levels, finest_scale=56):
    """(..., 4) xyxy rois -> (...,) int32 level by sqrt(area)."""
    scale = torch.sqrt(((rois[..., 2] - rois[..., 0]) *
                        (rois[..., 3] - rois[..., 1])).clamp(min=1e-6))
    lvl = torch.floor(torch.log2(_div(scale, finest_scale) + 1e-6))
    return lvl.to(torch.int32).clamp(0, num_levels - 1)


def _sample_axis(lo, bin_size, size, out_size, s):
    """Per-RoI sample coordinates along one axis, (R, out * s) each: the
    in-range mask, the two gathered indices and the weight of the upper
    one, in erd_tpu's _bilinear_gather arithmetic."""
    dev = lo.device
    sub = _div(torch.arange(s, dtype=torch.float32, device=dev) + 0.5, s)
    grid = (torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
            + sub[None, :]).reshape(-1)
    pos = lo[:, None] + bin_size[:, None] * grid[None, :]
    inside = (pos >= -1.0) & (pos <= size)
    p = pos.clamp(min=0.0)
    i0 = p.to(torch.int64).clamp(max=size - 1)
    p = torch.where(i0 >= size - 1, torch.full_like(p, size - 1), p)
    i1 = (i0 + 1).clamp(max=size - 1)
    return inside, i0, i1, p - i0.to(torch.float32)


def roi_align_level(feat, rois, spatial_scale, out_size=7, sampling_ratio=2):
    """Plain RoIAlign of one level: feat (C, H, W), rois (R, 4) xyxy in
    image coordinates -> (R, C, out, out) float32."""
    feat = feat.float()
    c, h, w = feat.shape
    r, s = rois.shape[0], sampling_ratio
    x1 = rois[:, 0] * spatial_scale - 0.5
    y1 = rois[:, 1] * spatial_scale - 0.5
    x2 = rois[:, 2] * spatial_scale - 0.5
    y2 = rois[:, 3] * spatial_scale - 0.5
    bin_w = _div((x2 - x1).clamp(min=1e-6), out_size)
    bin_h = _div((y2 - y1).clamp(min=1e-6), out_size)
    in_y, y0, y1i, wy = _sample_axis(y1, bin_h, h, out_size, s)
    in_x, x0, x1i, wx = _sample_axis(x1, bin_w, w, out_size, s)
    rows = feat.permute(1, 2, 0).reshape(h * w, c)  # pixel rows of C

    def gather(yi, xi):  # (R, S, S, C)
        idx = yi[:, :, None] * w + xi[:, None, :]
        return rows[idx.flatten()].reshape(*idx.shape, c)

    hy = (1 - wy)[:, :, None, None]
    ly = wy[:, :, None, None]
    hx = (1 - wx)[:, None, :, None]
    lx = wx[:, None, :, None]
    val = (gather(y0, x0) * hy * hx + gather(y0, x1i) * hy * lx +
           gather(y1i, x0) * ly * hx + gather(y1i, x1i) * ly * lx)
    inside = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    val = torch.where(inside, val, torch.zeros((), device=val.device))
    val = val.reshape(r, out_size, s, out_size, s, c)
    acc = torch.zeros((r, out_size, out_size, c), device=val.device)
    for iy in range(s):  # the kernel's summation order
        for ix in range(s):
            acc = acc + val[:, :, iy, :, ix]
    return _div(acc, s * s).permute(0, 3, 1, 2)


def roi_align_plain(feats, rois, levels, strides, out_size=7,
                    sampling_ratio=2):
    """Plain PyTorch version of the RoIAlign kernel (same arguments)."""
    b, r = levels.shape
    c = feats[0].shape[1]
    out = torch.zeros((b, r, c, out_size, out_size), dtype=torch.float32,
                      device=rois.device)
    for i in range(b):
        for lvl, (feat, stride) in enumerate(zip(feats, strides)):
            sel = torch.nonzero(levels[i] == lvl).flatten()
            if sel.numel():
                out[i, sel] = roi_align_level(feat[i], rois[i, sel],
                                              1.0 / stride, out_size,
                                              sampling_ratio)
    return out


def roi_align(feats: Sequence[torch.Tensor], rois, levels,
              strides=(4, 8, 16, 32), out_size=7, sampling_ratio=2):
    """RoIAlign of every RoI on its own level.

    Args:
        feats: per-level (B, C, H_l, W_l) float32 or bfloat16 maps (at most
            4 levels), all of one dtype.
        rois: (B, R, 4) float32 xyxy in image coordinates.
        levels: (B, R) int32 level of each RoI, in [0, len(feats)).
        strides: the levels' strides (spatial scale 1 / stride).
    Returns (B, R, C, out_size, out_size) float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch for the batch, counted in ``roi_align.launches``).
    """
    nl = len(feats)
    if not 1 <= nl <= 4 or len(strides) < nl:
        raise ValueError('roi_align takes 1 to 4 levels, each with a stride')
    b, c = feats[0].shape[:2]
    if rois.dim() != 3 or tuple(rois.shape[::2]) != (b, 4) or \
            tuple(levels.shape) != tuple(rois.shape[:2]):
        raise ValueError('rois must be (B, R, 4) and levels (B, R)')
    if any(f.dim() != 4 or tuple(f.shape[:2]) != (b, c) for f in feats):
        raise ValueError('feats must be (B, C, H, W) maps of one B and C')
    if rois.device.type == 'cpu':
        return roi_align_plain(feats, rois, levels, strides, out_size,
                               sampling_ratio)
    if rois.device.type != 'cuda':
        raise RuntimeError(f'roi_align: no kernel for {rois.device}')
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or \
            any(f.dtype != dtype for f in feats):
        raise TypeError('roi_align: feats must all be float32 or bfloat16')
    if rois.dtype != torch.float32 or levels.dtype != torch.int32:
        raise TypeError('roi_align: rois float32 and levels int32 expected')
    tensors = list(feats) + [rois, levels]
    if any(t.device != rois.device for t in tensors):
        raise ValueError('roi_align: all tensors must be on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('roi_align: tensors must be contiguous')
    r = rois.shape[1]
    out = torch.empty((b, r, c, out_size, out_size), dtype=torch.float32,
                      device=rois.device)
    ptrs = [f.data_ptr() for f in feats] + [None] * (4 - nl)
    hw = []
    for i in range(4):
        hw += list(feats[i].shape[2:]) if i < nl else [0, 0]
    scales = [1.0 / s for s in strides[:nl]] + [0.0] * (4 - nl)
    lib = cuda_build.load('roi_align')
    fn = lib.erd_roi_align
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 +
                   [ctypes.c_float] * 4 + [ctypes.c_int] * 6 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, rois.data_ptr(), levels.data_ptr(), out.data_ptr(),
                 *hw, *scales, b, r, c, out_size, sampling_ratio,
                 int(dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'roi_align')
    roi_align.launches += 1
    return out


roi_align.launches = 0


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois,
                         strides=(4, 8, 16, 32), out_size=7,
                         sampling_ratio=2, finest_scale=56):
    """feats: per-level (B, C, H_l, W_l) maps; rois (B, R, 4) in image
    coordinates -> (B, R, C, out, out) float32, each RoI on the level
    ``map_roi_levels`` gives it."""
    levels = map_roi_levels(rois, len(feats), finest_scale).contiguous()
    # cuDNN may hand the convolution outputs back channels-last
    return roi_align([f.contiguous() for f in feats], rois.contiguous(),
                     levels, strides, out_size, sampling_ratio)
