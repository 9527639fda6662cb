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
the plain version below (CPU tensors). ``roi_align`` is an autograd
Function: its gradient in the maps is ``roi_align_backward``, the backward
kernel of the same file or its plain version, a scatter-add of every
sample's four bilinear corners.

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


def acc_dtype(dtype):
    """The plain versions' accumulation dtype: float32, or float64 for
    float64 inputs (finite-difference checks)."""
    return torch.promote_types(dtype, torch.float32)


def roi_align_level(feat, rois, spatial_scale, out_size=7, sampling_ratio=2):
    """Plain RoIAlign of one level: feat (C, H, W), rois (R, 4) xyxy in
    image coordinates -> (R, C, out, out) float32 (float64 for a float64
    map)."""
    feat = feat.to(acc_dtype(feat.dtype))
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
    acc = torch.zeros((r, out_size, out_size, c), dtype=val.dtype,
                      device=val.device)
    for iy in range(s):  # the kernel's summation order
        for ix in range(s):
            acc = acc + val[:, :, iy, :, ix]
    return _div(acc, s * s).permute(0, 3, 1, 2)


def roi_align_plain(feats, rois, levels, strides, out_size=7,
                    sampling_ratio=2):
    """Plain PyTorch version of the RoIAlign kernel (same arguments)."""
    b, r = levels.shape
    c = feats[0].shape[1]
    out = torch.zeros((b, r, c, out_size, out_size),
                      dtype=acc_dtype(feats[0].dtype), device=rois.device)
    for i in range(b):
        for lvl, (feat, stride) in enumerate(zip(feats, strides)):
            sel = torch.nonzero(levels[i] == lvl).flatten()
            if sel.numel():
                out[i, sel] = roi_align_level(feat[i], rois[i, sel],
                                              1.0 / stride, out_size,
                                              sampling_ratio)
    return out


def _check(feats, rois, levels, strides):
    nl = len(feats)
    if not 1 <= nl <= 4 or len(strides) < nl:
        raise ValueError('roi_align takes 1 to 4 levels, each with a stride')
    b, c = feats[0].shape[:2]
    if rois.dim() != 3 or tuple(rois.shape[::2]) != (b, 4) or \
            tuple(levels.shape) != tuple(rois.shape[:2]):
        raise ValueError('rois must be (B, R, 4) and levels (B, R)')
    if any(f.dim() != 4 or tuple(f.shape[:2]) != (b, c) for f in feats):
        raise ValueError('feats must be (B, C, H, W) maps of one B and C')


def _check_cuda(what, tensors, rois, levels):
    """The kernels' argument rules: one CUDA device, float32 rois, int32
    levels, contiguous tensors."""
    if rois.device.type != 'cuda':
        raise RuntimeError(f'{what}: no kernel for {rois.device}')
    if rois.dtype != torch.float32 or levels.dtype != torch.int32:
        raise TypeError(f'{what}: rois float32 and levels int32 expected')
    tensors = list(tensors) + [rois, levels]
    if any(t.device != rois.device for t in tensors):
        raise ValueError(f'{what}: all tensors must be on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{what}: tensors must be contiguous')


def _level_args(shapes, strides):
    """(H_l, W_l) pairs and 1 / stride scales of 4 level slots."""
    nl = len(shapes)
    hw = []
    for i in range(4):
        hw += list(shapes[i]) if i < nl else [0, 0]
    return hw, [1.0 / s for s in strides[:nl]] + [0.0] * (4 - nl)


def _roi_align_kernel(feats, rois, levels, strides, out_size,
                      sampling_ratio):
    """Launch ``erd_roi_align`` (CUDA tensors); counted in
    ``roi_align.launches``."""
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or \
            any(f.dtype != dtype for f in feats):
        raise TypeError('roi_align: feats must all be float32 or bfloat16')
    _check_cuda('roi_align', feats, rois, levels)
    if not (out_size >= 1 and 1 <= sampling_ratio <= MAX_RATIO and
            out_size * sampling_ratio <= MAX_SAMPLES):
        raise ValueError(f'roi_align kernel: out_size * sampling_ratio at '
                         f'most {MAX_SAMPLES} and sampling_ratio 1 to '
                         f'{MAX_RATIO} (its sample tables), got {out_size} '
                         f'and {sampling_ratio}')
    b, c = feats[0].shape[:2]
    r, nl = rois.shape[1], len(feats)
    out = torch.empty((b, r, c, out_size, out_size), dtype=torch.float32,
                      device=rois.device)
    ptrs = [f.data_ptr() for f in feats] + [None] * (4 - nl)
    hw, scales = _level_args([f.shape[2:] for f in feats], strides)
    lib = cuda_build.load('roi_align')
    fn = lib.erd_roi_align
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 +
                   [ctypes.c_float] * 4 + [ctypes.c_int] * 7 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(rois.device).multi_processor_count
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, rois.data_ptr(), levels.data_ptr(), out.data_ptr(),
                 *hw, *scales, b, r, c, out_size, sampling_ratio, sms,
                 int(dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'roi_align')
    roi_align.launches += 1
    return out


class _RoIAlign(torch.autograd.Function):
    """RoIAlign with its gradient into the level maps; the RoIs and levels
    take none (erd_tpu samples detached proposals and gt boxes). The
    backward is ``roi_align_backward``: the kernel for CUDA tensors, the
    plain version for CPU tensors."""

    @staticmethod
    def forward(ctx, rois, levels, strides, out_size, sampling_ratio,
                *feats):
        ctx.save_for_backward(rois, levels)
        ctx.args = ([tuple(f.shape[2:]) for f in feats], feats[0].dtype,
                    strides, out_size, sampling_ratio)
        if rois.device.type == 'cpu':
            return roi_align_plain(feats, rois, levels, strides, out_size,
                                   sampling_ratio)
        return _roi_align_kernel(feats, rois, levels, strides, out_size,
                                 sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        shapes, dtype, strides, out_size, sampling_ratio = ctx.args
        grads = roi_align_backward(grad.contiguous(), rois, levels, shapes,
                                   strides, dtype, out_size, sampling_ratio)
        return (None,) * 5 + tuple(grads)


def roi_align(feats: Sequence[torch.Tensor], rois, levels,
              strides=(4, 8, 16, 32), out_size=7, sampling_ratio=2):
    """RoIAlign of every RoI on its own level.

    Args:
        feats: per-level (B, C, H_l, W_l) float32 or bfloat16 maps (at most
            4 levels), all of one dtype.
        rois: (B, R, 4) float32 xyxy in image coordinates.
        levels: (B, R) int32 level of each RoI, in [0, len(feats)).
        strides: the levels' strides (spatial scale 1 / stride).
    Returns (B, R, C, out_size, out_size) float32, differentiable in the
    maps (``roi_align_backward``).

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch for the batch, counted in ``roi_align.launches``), which takes
    out_size * sampling_ratio up to 32 and sampling_ratio up to 8, and
    raises beyond.
    """
    _check(feats, rois, levels, strides)
    if rois.device.type not in ('cpu', 'cuda'):
        raise RuntimeError(f'roi_align: no kernel for {rois.device}')
    return _RoIAlign.apply(rois, levels, tuple(strides), out_size,
                           sampling_ratio, *feats)


roi_align.launches = 0


def roi_align_backward_plain(grad, rois, levels, shapes, strides,
                             out_size=7, sampling_ratio=2):
    """Plain PyTorch version of the backward kernel: grad (B, R, C, out,
    out) float32 -> per-level (B, C, H_l, W_l) float32 gradients (float64
    for a float64 grad). Each
    sample's four bilinear corners get grad / s^2 times their weight, added
    with ``index_add_`` into the level's flattened (B * H * W, C) pixel
    rows; samples outside [-1, H] x [-1, W] and RoIs of other levels add
    nothing (the transpose of erd_tpu's gathers, mask and one-hot)."""
    b, r, c = grad.shape[:3]
    s, dev = sampling_ratio, grad.device
    g = _div(grad.to(acc_dtype(grad.dtype)), s * s).permute(0, 1, 3, 4, 2)
    g = g.repeat_interleave(s, 2).repeat_interleave(s, 3)  # (B, R, S, S, C)
    out = []
    for lvl, ((h, w), stride) in enumerate(zip(shapes, strides)):
        rows = torch.zeros((b * h * w, c), dtype=g.dtype, device=dev)
        for i in range(b):
            sel = torch.nonzero(levels[i] == lvl).flatten()
            if not sel.numel():
                continue
            scale = 1.0 / stride
            box = rois[i, sel] * scale - 0.5
            size = _div((box[:, 2:] - box[:, :2]).clamp(min=1e-6), out_size)
            in_y, y0, y1, ly = _sample_axis(box[:, 1], size[:, 1], h,
                                            out_size, s)
            in_x, x0, x1, lx = _sample_axis(box[:, 0], size[:, 0], w,
                                            out_size, s)
            inside = (in_y[:, :, None] & in_x[:, None, :])[..., None]
            gi = torch.where(inside, g[i, sel],
                             torch.zeros((), device=dev))
            hy, hx = (1 - ly)[:, :, None], (1 - lx)[:, None, :]
            ly, lx = ly[:, :, None], lx[:, None, :]
            base = i * h * w
            for yi, xi, wt in ((y0, x0, hy * hx), (y0, x1, hy * lx),
                               (y1, x0, ly * hx), (y1, x1, ly * lx)):
                idx = base + yi[:, :, None] * w + xi[:, None, :]
                rows.index_add_(0, idx.flatten(),
                                (gi * wt[..., None]).reshape(-1, c))
        out.append(rows.view(b, h, w, c).permute(0, 3, 1, 2).contiguous())
    return out


def roi_align_backward(grad, rois, levels, shapes, strides=(4, 8, 16, 32),
                       dtype=torch.float32, out_size=7, sampling_ratio=2):
    """Gradient of ``roi_align`` in its maps.

    Args:
        grad: (B, R, C, out, out) float32, the gradient of the output.
        rois, levels: as ``roi_align`` took them.
        shapes: the levels' (H_l, W_l).
        dtype: the maps' dtype, float32 or bfloat16.
    Returns per-level (B, C, H_l, W_l) gradients in ``dtype``: float32 sums,
    each rounded once to ``dtype`` (the transpose of erd_tpu's
    ``astype(float32)`` of the maps).

    CPU tensors take the plain version; CUDA tensors launch
    ``erd_roi_align_backward`` (one call for the batch, counted in
    ``roi_align_backward.launches``): a memset of a float32 channels-last
    scratch, the kernel's float4 atomic adds into it, and a pass that
    rounds it into the NCHW gradients; out_size at most 32 and
    sampling_ratio 1 to 8, else it raises.
    """
    nl = len(shapes)
    if not 1 <= nl <= 4 or len(strides) < nl:
        raise ValueError('roi_align_backward takes 1 to 4 levels, each with '
                         'a stride')
    b, r = levels.shape
    if grad.dim() != 5 or tuple(grad.shape[:2]) != (b, r) or \
            tuple(grad.shape[3:]) != (out_size, out_size) or \
            tuple(rois.shape) != (b, r, 4):
        raise ValueError('roi_align_backward: grad must be (B, R, C, out, '
                         'out), rois (B, R, 4) and levels (B, R)')
    if rois.device.type == 'cpu':
        return [g.to(dtype) for g in roi_align_backward_plain(
            grad, rois, levels, shapes, strides, out_size, sampling_ratio)]
    if grad.dtype != torch.float32 or \
            dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('roi_align_backward: float32 grad, float32 or '
                        'bfloat16 maps expected')
    _check_cuda('roi_align_backward', [grad], rois, levels)
    if not (1 <= out_size <= MAX_OUT and 1 <= sampling_ratio <= MAX_RATIO):
        raise ValueError(f'roi_align_backward kernel: out_size at most '
                         f'{MAX_OUT} and sampling_ratio 1 to {MAX_RATIO}, '
                         f'got {out_size} and {sampling_ratio}')
    c = grad.shape[2]
    scratch = _backward_scratch(grad, shapes)
    outs = [torch.empty((b, c, h, w), dtype=dtype, device=rois.device)
            for h, w in shapes]
    hw, scales = _level_args(shapes, strides)
    lib = cuda_build.load('roi_align')
    fn = lib.erd_roi_align_backward
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 +
                   [ctypes.c_float] * 4 + [ctypes.c_int] * 6 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(grad.data_ptr(), rois.data_ptr(), levels.data_ptr(),
                 scratch.data_ptr(),
                 *([o.data_ptr() for o in outs] + [None] * (4 - nl)),
                 *hw, *scales, b, r, c, out_size, sampling_ratio,
                 int(dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'roi_align_backward')
    roi_align_backward.launches += 1
    return outs


MAX_OUT, MAX_RATIO = 32, 8  # the backward kernel's shared tables
MAX_SAMPLES = 32  # the forward kernel's: out_size * sampling_ratio a side


def scratch_channels(c):
    """The channel stride of the backward's channels-last scratch: C
    rounded up to 4 (float4 rows)."""
    return -(-c // 4) * 4


def _scratch_layout(grad, shapes):
    """(floats, flag bytes) of the backward kernel's scratch: the levels'
    (B, H_l, W_l, C') channels-last maps one after another, then a byte a
    32-pixel tile of each level's flat H_l * W_l (set where the kernel
    adds)."""
    b, c = grad.shape[0], grad.shape[2]
    return (b * sum(h * w for h, w in shapes) * scratch_channels(c),
            b * sum(-(-h * w // 32) for h, w in shapes))


def _backward_scratch(grad, shapes):
    """The backward kernel's scratch, flat float32 (``_scratch_layout``)."""
    floats, flag_bytes = _scratch_layout(grad, shapes)
    return torch.empty(floats + -(-flag_bytes // 4), dtype=torch.float32,
                       device=grad.device)


roi_align_backward.launches = 0


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
