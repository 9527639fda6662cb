"""Corner pooling; the counterpart of ``corner_pool`` in
erd_tpu/ops/extra_nms.py (CornerNet's running maxima). The file's other
functions, ``matrix_nms``, ``fast_nms`` and ``nms_match``, have no model
caller in erd_tpu and are not ported yet (ROADMAP.md, section 2).

``corner_pool(x, direction)``: each pixel takes the max over a ray of its
row or column, itself included. ``top`` takes everything below it (the scan
runs upward), ``bottom`` everything above it, ``left`` everything to its
right and ``right`` everything to its left, as mmcv's TopPool etc. and
erd_tpu's flipped ``lax.cummax``. Maps are the port's NCHW tensors; the
output has the input's dtype (a max is exact). CPU tensors take
``corner_pool_plain`` (``torch.cummax``); CUDA tensors launch the kernel
``csrc/corner_pool.cu`` (one launch per call, counted in
``corner_pool.launches``).

The gradient (``corner_pool_backward``) is erd_tpu's: JAX differentiates
``cummax`` through ``lax.associative_scan`` with ``lax.max`` as the combine,
and ``lax.max`` gives half of the tangent to each of two tied operands, so a
tied run of a ray shares its outputs' gradients by the scan's tree, not by
position (``torch.cummax``'s own backward sends each output's gradient to
one index: a different function wherever a ReLU'd input ties). The plain
version replays JAX's recursion with ``torch.maximum`` (whose backward also
splits a tie 0.5 / 0.5) and takes its vector-Jacobian product; the kernel
walks the same tree. ``top`` and ``left`` run the tree over the flipped
ray, as erd_tpu's ``flip(cummax(flip(x)))`` does.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .roi_align import acc_dtype

# direction -> (the axis of the scan: 2 rows / 3 columns, scanned backward)
DIRECTIONS = {'bottom': (2, False), 'top': (2, True),
              'right': (3, False), 'left': (3, True)}


def _direction(direction):
    if direction not in DIRECTIONS:
        raise ValueError(f'corner_pool: direction must be one of '
                         f'{tuple(DIRECTIONS)}, got {direction!r}')
    return DIRECTIONS[direction]


def corner_pool_plain(x, direction):
    """Plain PyTorch version of the kernel: ``torch.cummax`` along H
    (``bottom``) or W (``right``), with erd_tpu's flips for ``top`` and
    ``left``."""
    dim, backward = _direction(direction)
    if backward:
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values


def _check(x, direction):
    dim, backward = _direction(direction)
    if x.dim() != 4:
        raise ValueError(f'corner_pool: x must be (B, C, H, W), got '
                         f'{tuple(x.shape)}')
    if x.device.type not in ('cpu', 'cuda'):
        raise RuntimeError(f'corner_pool: no kernel for {x.device}')
    if x.device.type == 'cuda' and x.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise TypeError('corner_pool: x must be float32 or bfloat16')
    return dim, backward


def _corner_pool_kernel(x, direction):
    """Launch ``erd_corner_pool`` (CUDA tensors); counted in
    ``corner_pool.launches``."""
    dim, backward = _direction(direction)
    x = x.contiguous()
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    lib = cuda_build.load('corner_pool')
    fn = lib.erd_corner_pool
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), b * c, h, w, int(dim == 3),
                 int(backward), int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'corner_pool')
    corner_pool.launches += 1
    return out


class _CornerPool(torch.autograd.Function):
    """``corner_pool`` with erd_tpu's gradient (``corner_pool_backward``):
    the plain versions for CPU tensors, the kernels for CUDA tensors."""

    @staticmethod
    def forward(ctx, direction, x):
        ctx.save_for_backward(x)
        ctx.direction = direction
        if x.device.type == 'cpu':
            return corner_pool_plain(x, direction)
        return _corner_pool_kernel(x, direction)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return None, corner_pool_backward(x, grad, ctx.direction)


def corner_pool(x, direction):
    """Running max of ``x`` (B, C, H, W), float32 or bfloat16, in one of the
    four directions; the output has x's shape and dtype, and the gradient in
    x is erd_tpu's (``corner_pool_backward``).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check(x, direction)
    return _CornerPool.apply(direction, x)


corner_pool.launches = 0


def scan_max(x, dim: int):
    """JAX's ``associative_scan(lax.max, x, axis=dim)`` in torch (dim >= 0):
    adjacent pairs combined, the half-length scan by recursion, the even
    outputs combined from the odd ones, the two interleaved
    (jax/_src/lax/control_flow/loops.py). Its values are ``torch.cummax``'s;
    its autograd is JAX's tree of tie splits."""
    n = x.shape[dim]
    if n < 2:
        return x

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    odd = scan_max(torch.maximum(sl(x, 0, n - 1, 2), sl(x, 1, n, 2)), dim)
    even = torch.maximum(sl(odd, 0, -1) if n % 2 == 0 else odd,
                         sl(x, 2, None, 2))
    even = torch.cat([sl(x, 0, 1), even], dim)
    m = odd.shape[dim]
    out = torch.stack([sl(even, 0, m), odd], dim + 1).flatten(dim, dim + 1)
    return torch.cat([out, sl(even, m)], dim) if n % 2 else out


def corner_pool_backward_plain(x, grad, direction):
    """Plain PyTorch version of the backward kernel: the gradient in x of
    ``sum(corner_pool(x) * grad)`` through ``scan_max`` (flipped for ``top``
    and ``left``), in x's dtype (float64 stays float64)."""
    dim, backward = _direction(direction)
    with torch.enable_grad():
        xs = x.detach().to(acc_dtype(x.dtype)).requires_grad_(True)
        ray = xs.flip(dim) if backward else xs
        out = scan_max(ray, dim)
        out = out.flip(dim) if backward else out
        g, = torch.autograd.grad(out, xs, grad.to(xs.dtype))
    return g.to(x.dtype)


def corner_pool_backward(x, grad, direction):
    """Gradient of ``corner_pool`` in x: x and grad (B, C, H, W) of one
    dtype (float32 or bfloat16) -> (B, C, H, W) in that dtype, summed in
    float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``erd_corner_pool_backward`` (one launch a call, counted in
    ``corner_pool_backward.launches``).
    """
    dim, backward = _check(x, direction)
    if grad.shape != x.shape:
        raise ValueError(f'corner_pool_backward: grad {tuple(grad.shape)} '
                         f'for x {tuple(x.shape)}')
    if x.device.type == 'cpu':
        return corner_pool_backward_plain(x, grad, direction)
    x, grad = x.contiguous(), grad.to(x.dtype).contiguous()
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    lib = cuda_build.load('corner_pool')
    fn = lib.erd_corner_pool_backward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), grad.data_ptr(), out.data_ptr(), b * c, h, w,
                 int(dim == 3), int(backward), int(x.dtype == torch.bfloat16),
                 stream)
    cuda_build.check(lib, err, 'corner_pool_backward')
    corner_pool_backward.launches += 1
    return out


corner_pool_backward.launches = 0
