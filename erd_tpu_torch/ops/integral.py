"""GFL integral decoding: the plain ``integral`` and the fused candidate
decode ``integral_decode`` (kernel ``csrc/integral_decode.cu``).

``integral`` computes E[t] = sum_i softmax(logits)_i * i over the bins
{0..reg_max} of each box side, as erd_tpu/ops/integral.py does.
``integral_decode`` fuses what ``gfl_predict`` does with it for the top-k
candidate rows: integral, times the row's level stride, decode from the
anchor centre, clip to the image. It reads the rows where they lie: in the
head's (B, H, W, 68) level maps (float32 or bf16, any element strides; GFL
serving hands them over as the network leaves them) or in one flat (B, N,
68) map (the ERD distillation's teacher rows, unit strides, no clip).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple, Union

import torch

from ..structures.boxes import distance2bbox
from . import cuda_build

# the bins a side the kernel is compiled for (reg_max 16, every GFL config)
KERNEL_REG_MAX = 16
# the level maps one call takes (csrc/integral_decode.cu kMaxLevels)
MAX_LEVELS = 8

Logits = Union[torch.Tensor, Sequence[torch.Tensor]]


def integral(bbox_pred, reg_max=16):
    """(..., 4*(reg_max+1)) distribution logits -> (..., 4) distances."""
    shape = bbox_pred.shape
    x = bbox_pred.reshape(*shape[:-1], 4, reg_max + 1)
    p = torch.softmax(x, dim=-1)
    proj = torch.arange(reg_max + 1, dtype=p.dtype, device=p.device)
    return (p * proj).sum(dim=-1)


def flat_logits(reg: Logits) -> torch.Tensor:
    """(B, N, C) float32 logits: ``reg`` itself, or its level maps (B, H, W,
    C) flattened row-major and concatenated in float32 (erd_tpu's
    ``flatten_levels`` of the head's float32 outputs)."""
    if isinstance(reg, torch.Tensor):
        return reg
    b, c = reg[0].shape[0], reg[0].shape[-1]
    return torch.cat([m.reshape(b, -1, c).float() for m in reg], dim=1)


def integral_decode_plain(reg, rows, centers, strides, img_shape,
                          reg_max=16):
    """Plain PyTorch version of the decode kernel (same arguments; level
    maps are flattened to float32 first)."""
    reg = flat_logits(reg)
    idx = rows.unsqueeze(-1).expand(-1, -1, reg.shape[-1])
    dist = integral(torch.gather(reg, 1, idx), reg_max) * \
        strides[rows].unsqueeze(-1)
    return distance2bbox(centers[rows], dist, max_shape=img_shape)


class LevelPlan(NamedTuple):
    """The kernel's view of a call's level maps: ctypes arrays of their
    element strides (batch, row, column, channel), first rows and widths,
    a pointer array the call fills (the C entry reads it before it
    returns), the level count, the rows in all, the batch and channels,
    bf16 or not, and whether every map's strides allow the vector loads
    (unit-stride channels, rows on 4-element boundaries; the pointers are
    checked a call) and the alignment those need."""
    strides: ctypes.Array
    starts: ctypes.Array
    widths: ctypes.Array
    ptrs: ctypes.Array  # the maps' pointers, filled in a call
    count: int
    rows: int
    batch: int
    channels: int
    bf16: int
    vec_strides: bool
    align: int


_PLANS: Dict[Tuple, LevelPlan] = {}


def _level_views(reg: Logits):
    """[(B, H, W, C) map] of ``reg``: its level maps, or the flat (B, N, C)
    map as one level of height 1."""
    if isinstance(reg, torch.Tensor):
        if reg.dim() != 3:
            raise ValueError(f'integral_decode: reg must be (B, N, C), got '
                             f'{tuple(reg.shape)}')
        return [reg.unsqueeze(1)]
    if not 1 <= len(reg) <= MAX_LEVELS:
        raise ValueError(f'integral_decode: 1 to {MAX_LEVELS} level maps of '
                         f'(B, H, W, C) expected')
    return reg


def level_plan(maps) -> LevelPlan:
    """The cached ``LevelPlan`` of level maps (B, H, W, C) of one batch,
    channel count and dtype (float32 or bfloat16); raises on others."""
    key = tuple([(m.shape, m.stride()) for m in maps] + [maps[0].dtype])
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    if any(m.dim() != 4 for m in maps):
        raise ValueError(f'integral_decode: 1 to {MAX_LEVELS} level maps of '
                         f'(B, H, W, C) expected')
    b, c = maps[0].shape[0], maps[0].shape[-1]
    if any(m.shape[0] != b or m.shape[-1] != c or m.dtype != maps[0].dtype
           for m in maps):
        raise ValueError('integral_decode: level maps of one batch, channel '
                         'count and dtype expected')
    if maps[0].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('integral_decode: level maps must be float32 or '
                        'bfloat16')
    strides, starts, widths, row = [], [], [], 0
    for m in maps:
        # a dimension of size 1 is only ever indexed at 0: its stride is
        # taken as 0 (torch may give such a dimension any stride)
        strides.extend(st if size > 1 else 0
                       for size, st in zip(m.shape, m.stride()))
        starts.append(row)
        widths.append(m.shape[2])
        row += m.shape[1] * m.shape[2]
    if row >= 2 ** 31:
        raise ValueError('integral_decode: 2^31 rows or more')
    plan = LevelPlan(
        strides=(ctypes.c_longlong * len(strides))(*strides),
        starts=(ctypes.c_int * len(maps))(*starts),
        widths=(ctypes.c_int * len(maps))(*widths),
        ptrs=(ctypes.c_void_p * len(maps))(), count=len(maps),
        rows=row, batch=b, channels=c,
        bf16=int(maps[0].dtype == torch.bfloat16),
        vec_strides=all(strides[4 * i + 3] == 1 and all(
            s % 4 == 0 for s in strides[4 * i:4 * i + 3])
            for i in range(len(maps))),
        align=4 * maps[0].element_size())
    _PLANS[key] = plan
    return plan


# erd_integral_decode's arguments: the level pointers, strides, first rows
# and widths, the level count, bf16, vec; rows, centres, strides, img_shape,
# out; batch, K; the stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _check_shapes(b, n, rows, centers, strides, img_shape):
    if rows.dim() != 2 or rows.shape[0] != b:
        raise ValueError(f'rows must be (B, K), got {tuple(rows.shape)}')
    if centers.shape != (n, 2) or strides.shape != (n,) or \
            (img_shape is not None and img_shape.shape != (b, 2)):
        raise ValueError('centers (N, 2), strides (N,), img_shape (B, 2) '
                         'expected')


def integral_decode(reg: Logits, rows, centers, strides, img_shape,
                    reg_max=16):
    """Decode the candidate rows of the distribution logits.

    Args:
        reg: the logits, either the head's level maps, a sequence of
            (B, H_l, W_l, 4*(reg_max+1)) float32 or bfloat16 tensors of any
            element strides (row ``h * W_l + w`` of level l is anchor
            ``start_l + h * W_l + w``, erd_tpu's ``flatten_levels`` order),
            or one (B, N, 4*(reg_max+1)) float32 tensor.
        rows: (B, K) int64 anchor rows in [0, N) to decode.
        centers: (N, 2) fp32 anchor centres.
        strides: (N,) fp32 level stride of each anchor.
        img_shape: (B, 2) fp32 per-image (H, W) to clip into, or None for
            no clip.
    Returns (B, K, 4) fp32 xyxy boxes.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch for the batch, the maps read where they lie, counted in
    ``integral_decode.launches``), which takes reg_max 16 only.
    """
    maps = _level_views(reg)
    device = maps[0].device
    if device.type == 'cpu':
        if any(m.dim() != 4 for m in maps):
            raise ValueError(f'integral_decode: 1 to {MAX_LEVELS} level maps '
                             f'of (B, H, W, C) expected')
        c = maps[0].shape[-1]
        if c != 4 * (reg_max + 1):
            raise ValueError(f'reg has {c} channels, expected '
                             f'{4 * (reg_max + 1)}')
        _check_shapes(maps[0].shape[0],
                      sum(m.shape[1] * m.shape[2] for m in maps), rows,
                      centers, strides, img_shape)
        return integral_decode_plain(reg, rows, centers, strides, img_shape,
                                     reg_max)
    if device.type != 'cuda':
        raise RuntimeError(f'integral_decode: no kernel for {device}')
    plan = level_plan(maps)
    if plan.channels != 4 * (reg_max + 1):
        raise ValueError(f'reg has {plan.channels} channels, expected '
                         f'{4 * (reg_max + 1)}')
    _check_shapes(plan.batch, plan.rows, rows, centers, strides, img_shape)
    if reg_max != KERNEL_REG_MAX:
        raise ValueError(f'integral_decode: the kernel takes reg_max '
                         f'{KERNEL_REG_MAX}, got {reg_max}')
    if plan.bf16 and isinstance(reg, torch.Tensor):
        raise TypeError('integral_decode: a flat reg must be float32')
    if rows.dtype != torch.int64 or not rows.is_contiguous():
        raise TypeError('integral_decode: rows must be contiguous int64')
    index = device.index
    ptrs, vec = plan.ptrs, plan.vec_strides
    for i, m in enumerate(maps):
        if m.get_device() != index:
            raise ValueError('integral_decode: all tensors must be on one '
                             'device')
        p = m.data_ptr()
        ptrs[i] = p
        vec = vec and p % plan.align == 0
    small = []
    for t in (centers, strides, img_shape):
        if t is None:  # no img_shape: no clip
            small.append(None)
            continue
        if t.get_device() != index or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise TypeError('integral_decode: centers, strides and img_shape '
                            'must be contiguous float32 on the maps\' device')
        small.append(t.data_ptr())
    if rows.get_device() != index:
        raise ValueError('integral_decode: all tensors must be on one device')
    b, k = rows.shape
    out = torch.empty((b, k, 4), dtype=torch.float32, device=device)
    fn = cuda_build.entry('integral_decode', 'erd_integral_decode',
                          _ARGTYPES)
    with cuda_build.on_device(device):
        err = fn(ptrs, plan.strides, plan.starts, plan.widths, plan.count,
                 plan.bf16, int(vec),
                 rows.data_ptr(), small[0], small[1], small[2],
                 out.data_ptr(), b, k, cuda_build.stream_handle(device))
    if err:
        cuda_build.check(cuda_build.load('integral_decode'), err,
                         'integral_decode')
    integral_decode.launches += 1
    return out


integral_decode.launches = 0
