"""Bilinear point sampling; the counterpart of ``point_sample`` in
erd_tpu/ops/sampling.py.

``point_sample`` samples maps at normalised [0, 1] point coordinates (x, y)
with grid_sample's ``align_corners=False`` convention (pixel centres at
(i + 0.5) / size) and zero padding per corner: each of the four bilinear
corners outside the map contributes 0, the others their weighted value, as
erd_tpu's ``_grid_sample_bilinear`` does. One call takes a batch of maps and
a batch of point sets, which covers both of PointRend's calls: the coarse
call (one 14x14 logit map per RoI, its own points) and the fine call (one
P2 map per image, the points of all of that image's RoIs).

Maps are the port's NCHW tensors, read through their strides (NCHW or
channels-last memory alike); the output is (N, K, C) float32, the samples of
the widened map, as erd_tpu samples ``astype(float32)`` maps. CPU tensors
take ``point_sample_plain``; CUDA tensors launch the kernel
``csrc/point_sample.cu`` (one launch per call, counted in
``point_sample.launches``). ``align_corners=True`` has no kernel: no model
path uses it, and it raises on CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .roi_align import acc_dtype

TRAIN_ITEM = ('ROADMAP.md, section 1: the training of Mask R-CNN, PointRend '
              'and CornerNet')


def _sample_coords(points, h, w, align_corners):
    """erd_tpu's unnormalised pixel coordinates (xs, ys) of (N, K, 2)
    points."""
    if align_corners:
        return points[..., 0] * (w - 1), points[..., 1] * (h - 1)
    return points[..., 0] * w - 0.5, points[..., 1] * h - 0.5


def point_sample_plain(maps, points, align_corners=False):
    """Plain PyTorch version of the kernel: maps (N, C, H, W), points (N,
    K, 2) in [0, 1] as (x, y) -> (N, K, C) float32 (float64 for a float64
    map), erd_tpu's bilinear arithmetic: v00 * (1 - wy) * (1 - wx) + v01 *
    (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx, left to right, a
    corner off the map reading 0."""
    n, c, h, w = maps.shape
    k = points.shape[1]
    rows = maps.permute(0, 2, 3, 1).reshape(n, h * w, c).to(
        acc_dtype(maps.dtype))
    xs, ys = _sample_coords(points.to(rows.dtype), h, w, align_corners)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)

    def corner(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = torch.gather(rows, 1, idx[..., None].expand(n, k, c))
        return torch.where(ok[..., None], v, zero)

    return (corner(y0, x0) * (1 - wy) * (1 - wx) +
            corner(y0, x0 + 1) * (1 - wy) * wx +
            corner(y0 + 1, x0) * wy * (1 - wx) +
            corner(y0 + 1, x0 + 1) * wy * wx)


def _point_sample_kernel(maps, points):
    """Launch ``erd_point_sample`` (CUDA tensors); counted in
    ``point_sample.launches``."""
    if maps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('point_sample: maps must be float32 or bfloat16')
    if points.dtype != torch.float32 or points.device != maps.device:
        raise TypeError('point_sample: float32 points on the maps\' device '
                        'expected')
    points = points.contiguous()
    n, c, h, w = maps.shape
    k = points.shape[1]
    out = torch.empty((n, k, c), dtype=torch.float32, device=maps.device)
    lib = cuda_build.load('point_sample')
    fn = lib.erd_point_sample
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 +
                   [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(maps.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(maps.data_ptr(), points.data_ptr(), out.data_ptr(), n, c, h,
                 w, k, *maps.stride(), int(maps.dtype == torch.bfloat16),
                 stream)
    cuda_build.check(lib, err, 'point_sample')
    point_sample.launches += 1
    return out


def point_sample(maps, points, align_corners=False):
    """Bilinear samples of ``maps`` at ``points``.

    Args:
        maps: (N, C, H, W) float32 or bfloat16, any strides.
        points: (N, K, 2) float32, (x, y) in [0, 1] of the map's extent.
    Returns (N, K, C) float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which has no backward yet and raises where autograd would need one.
    """
    if maps.dim() != 4 or points.dim() != 3 or points.shape[-1] != 2 or \
            points.shape[0] != maps.shape[0]:
        raise ValueError(f'point_sample: maps (N, C, H, W) and points (N, K, '
                         f'2) expected, got {tuple(maps.shape)} and '
                         f'{tuple(points.shape)}')
    if maps.device.type == 'cpu':
        return point_sample_plain(maps, points, align_corners)
    if maps.device.type != 'cuda':
        raise RuntimeError(f'point_sample: no kernel for {maps.device}')
    if align_corners:
        raise NotImplementedError('point_sample: align_corners=True has no '
                                  'kernel (no model path uses it)')
    if torch.is_grad_enabled() and (maps.requires_grad or
                                    points.requires_grad):
        raise NotImplementedError(f'point_sample has no backward kernel yet '
                                  f'({TRAIN_ITEM})')
    return _point_sample_kernel(maps, points)


point_sample.launches = 0
