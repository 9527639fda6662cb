"""Multi-scale deformable attention sampling; the counterpart of
erd_tpu/ops/ms_deform_attn.py.

Per query, head, level and point, one bilinear read of the level's value
map at a learned location (``padding_mode='zeros'``: a corner outside the
map reads 0), times the point's softmaxed attention weight; the points of a
level are summed, then the levels from 0 up.

Layout: the values are the flat tokens of all levels, (B, N_tok, heads, hd),
level l at rows ``level_start[l] : level_start[l + 1]`` in row-major (H_l,
W_l) order, i.e. the encoder's token sequence after one ``value_proj``.
erd_tpu projects each level's map on its own; the products are the same
rows, so the numbers agree up to the GEMM's blocking.

CPU tensors take the plain version below; CUDA tensors launch the kernel
``csrc/ms_deform_attn.cu`` (one launch per call, counted in
``ms_deform_attn.launches``), or raise.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

NOT_TRAINED_YET = ('multi-scale deformable attention has no backward yet: '
                   'DETR training is not ported (ROADMAP.md, section 1: '
                   '"DINO and Deformable DETR training")')

MAX_LEVELS = 4
KERNEL_HEAD_DIM = 32  # one lane of a warp per channel


def make_level_start_index(spatial_shapes):
    """Row offset of each level in the flat tokens, and the total at the
    end: [0, H0*W0, H0*W0 + H1*W1, ...]."""
    sizes = [h * w for h, w in spatial_shapes]
    return np.concatenate([[0], np.cumsum(sizes)])


def ms_deform_attn_plain(values, spatial_shapes, locations, weights):
    """Plain PyTorch version, erd_tpu's arithmetic op for op.

    Per level: ``xs = x * W - 0.5``, ``ys = y * H - 0.5``, floor, the four
    corner reads (0 outside the map), ``v00*(1-wy)*(1-wx) + v01*(1-wy)*wx +
    v10*wy*(1-wx) + v11*wy*wx`` left to right, times the weight; the points
    summed in order from a zero, then the levels from a zero in order (the
    kernel's order; erd_tpu's XLA reduce over the points may order them
    otherwise).
    """
    b, n, heads, hd = values.shape
    q, levels, points = locations.shape[1], locations.shape[3], \
        locations.shape[4]
    dev = values.device
    weights = weights.float()
    starts = make_level_start_index(spatial_shapes)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    hidx = torch.arange(heads, device=dev)[None, None, :, None]
    total = torch.zeros((b, q, heads, hd), dtype=torch.float32, device=dev)
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = values[:, int(starts[lvl]):int(starts[lvl + 1])]
        loc = locations[:, :, :, lvl]  # (B, Q, heads, K, 2)
        xs = loc[..., 0] * w - 0.5
        ys = loc[..., 1] * h - 0.5
        x0 = torch.floor(xs)
        y0 = torch.floor(ys)
        wx = (xs - x0)[..., None]
        wy = (ys - y0)[..., None]
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)

        def read(yy, xx):
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            return torch.where(ok[..., None], v[bidx, idx, hidx],
                               torch.zeros((), device=dev))

        samp = (read(y0i, x0i) * (1 - wy) * (1 - wx) +
                read(y0i, x0i + 1) * (1 - wy) * wx +
                read(y0i + 1, x0i) * wy * (1 - wx) +
                read(y0i + 1, x0i + 1) * wy * wx)
        samp = samp * weights[:, :, :, lvl][..., None]
        acc = torch.zeros_like(total)
        for p in range(points):
            acc = acc + samp[..., p, :]
        total = total + acc
    return total


def _check(values, spatial_shapes, locations, weights) -> Tuple[int, ...]:
    if values.dim() != 4 or locations.dim() != 6 or weights.dim() != 5:
        raise ValueError('ms_deform_attn: values (B, N, heads, hd), '
                         'locations (B, Q, heads, L, K, 2) and weights '
                         '(B, Q, heads, L, K) expected')
    b, n, heads, _ = values.shape
    _, q, _, levels, points, two = locations.shape
    if tuple(locations.shape[:3]) != (b, q, heads) or two != 2 or \
            tuple(weights.shape) != tuple(locations.shape[:5]):
        raise ValueError('ms_deform_attn: locations and weights do not '
                         'match the values')
    if not 1 <= levels <= MAX_LEVELS or len(spatial_shapes) != levels:
        raise ValueError(f'ms_deform_attn takes 1 to {MAX_LEVELS} levels, '
                         f'one (H, W) each')
    if int(make_level_start_index(spatial_shapes)[-1]) != n:
        raise ValueError('ms_deform_attn: the level shapes do not cover '
                         'the value tokens')
    return b, n, heads, q, levels, points


def ms_deform_attn(values, spatial_shapes: Sequence[Tuple[int, int]],
                   locations, weights):
    """Multi-scale deformable attention sampling.

    Args:
        values: (B, N_tok, heads, hd) float32 flat tokens of all levels.
        spatial_shapes: the levels' (H, W), host ints, summing to N_tok.
        locations: (B, Q, heads, L, K, 2) float32 normalized xy.
        weights: (B, Q, heads, L, K) attention weights, float32, or bf16
            (widened exactly to float32).
    Returns (B, Q, heads, hd) float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Serving only: raises when an input needs a gradient.
    """
    b, n, heads, q, levels, points = _check(values, spatial_shapes,
                                            locations, weights)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (values, locations, weights)):
        raise NotImplementedError(NOT_TRAINED_YET)
    if values.device.type == 'cpu':
        return ms_deform_attn_plain(values, spatial_shapes, locations,
                                    weights)
    if values.device.type != 'cuda':
        raise RuntimeError(f'ms_deform_attn: no kernel for {values.device}')
    if weights.dtype == torch.bfloat16:
        weights = weights.float()
    if any(t.dtype != torch.float32 for t in (values, locations, weights)):
        raise TypeError('ms_deform_attn: float32 values and locations, '
                        'float32 or bf16 weights expected')
    tensors = (values, locations, weights)
    if any(t.device != values.device for t in tensors):
        raise ValueError('ms_deform_attn: all tensors must be on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('ms_deform_attn: tensors must be contiguous')
    hd = values.shape[3]
    if hd != KERNEL_HEAD_DIM or levels * points > 32:
        raise ValueError(f'ms_deform_attn kernel: head_dim must be '
                         f'{KERNEL_HEAD_DIM} and L * K at most 32, got '
                         f'{hd} and {levels * points}')
    out = torch.empty((b, q, heads, hd), dtype=torch.float32,
                      device=values.device)
    starts = make_level_start_index(spatial_shapes)
    hw = []
    for lvl in range(MAX_LEVELS):
        hw += list(spatial_shapes[lvl]) if lvl < levels else [0, 0]
    lib = cuda_build.load('ms_deform_attn')
    fn = lib.erd_ms_deform_attn
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 +
                   [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(values.data_ptr(), locations.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), *hw,
                 *[int(starts[i]) if i < levels else 0
                   for i in range(MAX_LEVELS)],
                 b, n, q, heads, levels, points, stream)
    cuda_build.check(lib, err, 'ms_deform_attn')
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
