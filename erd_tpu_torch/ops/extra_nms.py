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
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .sampling import TRAIN_ITEM

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


def corner_pool(x, direction):
    """Running max of ``x`` (B, C, H, W), float32 or bfloat16, in one of the
    four directions; the output has x's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which has no backward yet and raises where autograd would need one.
    """
    dim, backward = _direction(direction)
    if x.dim() != 4:
        raise ValueError(f'corner_pool: x must be (B, C, H, W), got '
                         f'{tuple(x.shape)}')
    if x.device.type == 'cpu':
        return corner_pool_plain(x, direction)
    if x.device.type != 'cuda':
        raise RuntimeError(f'corner_pool: no kernel for {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('corner_pool: x must be float32 or bfloat16')
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(f'corner_pool has no backward kernel yet '
                                  f'({TRAIN_ITEM})')
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


corner_pool.launches = 0
