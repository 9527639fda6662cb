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
``ms_deform_attn.launches``), or raise. ``ms_deform_attn`` is an autograd
Function: its gradients in the values, locations and weights are
``ms_deform_attn_backward``, the backward kernel of the same file
(``erd_ms_deform_attn_backward``, counted in
``ms_deform_attn_backward.launches``) or its plain version, the transpose
of erd_tpu's gathers written out.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from .roi_align import acc_dtype

MAX_LEVELS = 4
KERNEL_HEAD_DIM = 32  # 32 channels: a warp's 8 lanes of float4 per row
# the backward kernel's blocks (``ms_deform_attn_backward_run``): 8 warps
# take up to RUN consecutive queries of one (image, head), fewer on calls
# that would give an SM fewer than RUN_ROUNDS rounds of 32 warps
RUN, RUN_ROUNDS = 64, 16
SM_COUNT = 132  # an H100 SXM


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
    acc = acc_dtype(values.dtype)
    weights = weights.to(acc)
    starts = make_level_start_index(spatial_shapes)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    hidx = torch.arange(heads, device=dev)[None, None, :, None]
    total = torch.zeros((b, q, heads, hd), dtype=acc, device=dev)
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


def _level_args(spatial_shapes, levels):
    """The kernels' (h, w) x 4 and start x 4 level arguments."""
    starts = make_level_start_index(spatial_shapes)
    hw = []
    for lvl in range(MAX_LEVELS):
        hw += list(spatial_shapes[lvl]) if lvl < levels else [0, 0]
    return hw + [int(starts[i]) if i < levels else 0
                 for i in range(MAX_LEVELS)]


def _check_cuda(what, values, locations, weights, extra=()):
    """The kernels' input rules; returns the weights widened to float32."""
    if weights.dtype == torch.bfloat16:
        weights = weights.float()
    tensors = (values, locations, weights) + tuple(extra)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f'{what}: float32 values, locations and gradients, '
                        f'float32 or bf16 weights expected')
    if any(t.device != values.device for t in tensors):
        raise ValueError(f'{what}: all tensors must be on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{what}: tensors must be contiguous')
    if any(t.data_ptr() % 16 for t in (values,) + tuple(extra)):
        raise ValueError(f'{what}: the value rows (and gradients) must '
                         f'start on 16 bytes: the kernels read float4s')
    hd = values.shape[3]
    levels, points = locations.shape[3], locations.shape[4]
    if hd != KERNEL_HEAD_DIM or levels * points > 32:
        raise ValueError(f'{what} kernel: head_dim must be '
                         f'{KERNEL_HEAD_DIM} and L * K at most 32, got '
                         f'{hd} and {levels * points}')
    return weights


def _forward_kernel(values, spatial_shapes, locations, weights):
    b, n, heads, q, levels, points = _check(values, spatial_shapes,
                                            locations, weights)
    weights = _check_cuda('ms_deform_attn', values, locations, weights)
    out = torch.empty((b, q, heads, values.shape[3]), dtype=torch.float32,
                      device=values.device)
    lib = cuda_build.load('ms_deform_attn')
    fn = lib.erd_ms_deform_attn
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 +
                   [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(values.data_ptr(), locations.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), *_level_args(spatial_shapes, levels),
                 b, n, q, heads, levels, points, stream)
    cuda_build.check(lib, err, 'ms_deform_attn')
    ms_deform_attn.launches += 1
    return out


class _MSDeformAttn(torch.autograd.Function):
    """The sampling with its gradients in the values, the locations and
    the weights (``ms_deform_attn_backward``); the forward's samples are
    recomputed, not stored."""

    @staticmethod
    def forward(ctx, values, locations, weights, spatial_shapes):
        ctx.save_for_backward(values, locations, weights)
        ctx.spatial_shapes = spatial_shapes
        if values.device.type == 'cpu':
            return ms_deform_attn_plain(values, spatial_shapes, locations,
                                        weights)
        return _forward_kernel(values, spatial_shapes, locations, weights)

    @staticmethod
    def backward(ctx, grad):
        values, locations, weights = ctx.saved_tensors
        grads = ms_deform_attn_backward(values, ctx.spatial_shapes,
                                        locations, weights,
                                        grad.contiguous())
        return grads + (None,)


def ms_deform_attn(values, spatial_shapes: Sequence[Tuple[int, int]],
                   locations, weights):
    """Multi-scale deformable attention sampling.

    Args:
        values: (B, N_tok, heads, hd) float32 flat tokens of all levels.
        spatial_shapes: the levels' (H, W), host ints, summing to N_tok.
        locations: (B, Q, heads, L, K, 2) float32 normalized xy.
        weights: (B, Q, heads, L, K) attention weights, float32, or bf16
            (widened exactly to float32).
    Returns (B, Q, heads, hd) float32 (float64 for float64 values on the
    CPU), differentiable in the values, the locations and the weights
    (``ms_deform_attn_backward``; bf16 weights take a bf16 gradient).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check(values, spatial_shapes, locations, weights)
    if values.device.type not in ('cpu', 'cuda'):
        raise RuntimeError(f'ms_deform_attn: no kernel for {values.device}')
    return _MSDeformAttn.apply(values, locations, weights,
                               tuple(tuple(int(v) for v in s)
                                     for s in spatial_shapes))


ms_deform_attn.launches = 0


def ms_deform_attn_backward_plain(values, spatial_shapes, locations, weights,
                                  grad):
    """Plain PyTorch version of the backward kernel: the gradients (values
    (B, N_tok, heads, hd), locations (B, Q, heads, L, K, 2), weights (B, Q,
    heads, L, K)) of ``ms_deform_attn_plain`` for the output gradient
    ``grad`` (B, Q, heads, hd), in float32 (float64 for float64 values).

    Per sample, with corner coefficients c_k, corner values v_k (0 off the
    map) and weight a: each in-range corner's value row gets a * c_k * grad
    (``index_add_`` into the flattened (B * N_tok * heads, hd) rows); the
    weight gets sum_c grad * sum_k c_k v_k; loc_x gets a * W * sum_c grad *
    ((v01 - v00)(1 - wy) + (v11 - v10) wy), loc_y likewise with H (floor's
    derivative is 0, as in JAX). One image and level at a time, so that the
    temporaries stay a level's size."""
    b, n, heads, hd = values.shape
    dev = values.device
    acc = acc_dtype(values.dtype)
    v_all = values.to(acc)
    g_all = grad.to(acc)
    w_all = weights.to(acc)
    starts = make_level_start_index(spatial_shapes)
    hidx = torch.arange(heads, device=dev)[None, :, None]
    gv = torch.zeros((b * n * heads, hd), dtype=acc, device=dev)
    gl = torch.zeros(locations.shape, dtype=acc, device=dev)
    gw = torch.zeros(weights.shape, dtype=acc, device=dev)
    zero = torch.zeros((), dtype=acc, device=dev)
    for i in range(b):
        g = g_all[i][:, :, None, :]  # (Q, heads, 1, hd)
        for lvl, (h, w) in enumerate(spatial_shapes):
            start = int(starts[lvl])
            v = v_all[i, start:int(starts[lvl + 1])]
            loc = locations[i, :, :, lvl].to(acc)  # (Q, heads, K, 2)
            a = w_all[i, :, :, lvl]  # (Q, heads, K)
            xs = loc[..., 0] * w - 0.5
            ys = loc[..., 1] * h - 0.5
            x0 = torch.floor(xs)
            y0 = torch.floor(ys)
            wx, wy = xs - x0, ys - y0
            x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
            corners = {}
            for dy, cy in ((0, 1 - wy), (1, wy)):
                for dx, cx in ((0, 1 - wx), (1, wx)):
                    yy, xx = y0i + dy, x0i + dx
                    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                    idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
                    val = torch.where(ok[..., None], v[idx, hidx], zero)
                    coef = cy * cx
                    rows = ((i * n + start + idx) * heads + hidx)[ok]
                    gv.index_add_(0, rows, ((a * coef)[..., None] * g)[ok])
                    corners[dy, dx] = (val, coef)
            samp = sum(val * coef[..., None] for val, coef in
                       corners.values())
            gw[i, :, :, lvl] = (g * samp).sum(-1)
            (v00, _), (v01, _) = corners[0, 0], corners[0, 1]
            (v10, _), (v11, _) = corners[1, 0], corners[1, 1]
            gx = (v01 - v00) * (1 - wy)[..., None] + \
                (v11 - v10) * wy[..., None]
            gy = (v10 - v00) * (1 - wx)[..., None] + \
                (v11 - v01) * wx[..., None]
            gl[i, :, :, lvl, :, 0] = (g * gx).sum(-1) * a * w
            gl[i, :, :, lvl, :, 1] = (g * gy).sum(-1) * a * h
    return gv.view(b, n, heads, hd), gl, gw


def ms_deform_attn_backward_run(batch, q, heads, sms=SM_COUNT) -> int:
    """The queries of one (image, head) that a block of the backward kernel
    takes, from the call's shape (pure Python): a multiple of 8 (the
    block's warps take consecutive queries), RUN at most, and fewer on
    small calls (the decoders') so that every SM holds RUN_ROUNDS rounds of
    32 warps."""
    return 8 * max(1, min(RUN // 8, batch * heads * q //
                          (sms * 32 * RUN_ROUNDS)))


def ms_deform_attn_backward(values, spatial_shapes, locations, weights,
                            grad):
    """Gradients of ``ms_deform_attn`` for the output gradient ``grad``
    (B, Q, heads, hd) float32: (d values float32, d locations float32, d
    weights in the weights' dtype).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``erd_ms_deform_attn_backward`` on blocks of
    ``ms_deform_attn_backward_run`` queries (one launch per call, counted in
    ``ms_deform_attn_backward.launches``), or raise. Its value gradient is
    float32 atomics into a zeroed buffer: not deterministic. The location
    and weight gradients are deterministic.
    """
    b, n, heads, q, levels, points = _check(values, spatial_shapes,
                                            locations, weights)
    if tuple(grad.shape) != (b, q, heads, values.shape[3]):
        raise ValueError('ms_deform_attn_backward: grad must be (B, Q, '
                         'heads, hd)')
    if values.device.type == 'cpu':
        gv, gl, gw = ms_deform_attn_backward_plain(
            values, spatial_shapes, locations, weights, grad)
        return gv, gl, gw.to(weights.dtype)
    if values.device.type != 'cuda':
        raise RuntimeError(f'ms_deform_attn_backward: no kernel for '
                           f'{values.device}')
    wdtype = weights.dtype
    weights = _check_cuda('ms_deform_attn_backward', values, locations,
                          weights, (grad,))
    dev = values.device
    run = ms_deform_attn_backward_run(
        b, q, heads,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    gv = torch.zeros(values.shape, dtype=torch.float32, device=dev)
    gl = torch.empty(locations.shape, dtype=torch.float32, device=dev)
    gw = torch.empty(weights.shape, dtype=torch.float32, device=dev)
    lib = cuda_build.load('ms_deform_attn')
    fn = lib.erd_ms_deform_attn_backward
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 +
                   [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(values.data_ptr(), locations.data_ptr(), weights.data_ptr(),
                 grad.data_ptr(), gv.data_ptr(), gl.data_ptr(), gw.data_ptr(),
                 *_level_args(spatial_shapes, levels), b, n, q, heads,
                 levels, points, run, stream)
    cuda_build.check(lib, err, 'ms_deform_attn_backward')
    ms_deform_attn_backward.launches += 1
    return gv, gl, gw.to(wdtype)


ms_deform_attn_backward.launches = 0
