"""Bilinear point sampling and its gradient, and the masked convolution;
the counterparts of ``point_sample`` and ``masked_conv2d`` in
erd_tpu/ops/sampling.py.

``point_sample`` samples maps at normalised [0, 1] point coordinates (x, y)
with grid_sample's ``align_corners=False`` convention (pixel centres at
(i + 0.5) / size) and zero padding per corner: each of the four bilinear
corners outside the map contributes 0, the others their weighted value, as
erd_tpu's ``_grid_sample_bilinear`` does. One call takes a batch of maps and
a batch of point sets, which covers every PointRend call: the coarse calls
(one 14x14 logit map per RoI, its own points) and the fine call (one P2 map
per image, the points of all of that image's RoIs).

Maps are the port's NCHW tensors, read through their strides (NCHW or
channels-last memory alike); the output is (N, K, C) float32, the samples of
the widened map, as erd_tpu samples ``astype(float32)`` maps. The function
is differentiable in the maps (``point_sample_backward``: each pixel's
corners' weighted gradients summed in float32, rounded once to the map's
dtype, in the map's strides); the points get no gradient (erd_tpu's
points are uniform draws and top-k picks on detached RoIs), and points that
require one raise while grad is on. CPU tensors take the plain versions;
CUDA tensors launch the kernels of ``csrc/point_sample.cu`` (one launch per
call each way, counted in ``point_sample.launches`` and
``point_sample_backward.launches``); the forward runs in the layout that
``point_sample_plan`` picks from the maps' shape, strides and alignment
(a staged map, unit-stride channels or general strides), each equal to the
plain version to the bit. ``align_corners=True`` has no kernel: no model
path uses it, and it raises on CUDA tensors.

``masked_conv2d`` is mmcv's MaskedConv2d as erd_tpu states it: a float32
K x K convolution (symmetric padding (K - 1) // 2, any stride) plus bias,
times a mask at output resolution, on NCHW maps with an OIHW weight. CPU
tensors take ``masked_conv2d_plain`` (the dense IEEE float32 convolution
times the mask); CUDA tensors launch the kernel ``csrc/masked_conv.cu``,
an implicit GEMM over only the masked positions (one launch a call with at
least one position, counted in ``masked_conv2d.launches``;
``masked_conv_tile`` picks its tile). It takes no gradient: no model path
trains through it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import conv2d_ieee
from . import cuda_build
from .roi_align import acc_dtype

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


# the staged layout: the shared memory a block may fill (its maps, and
# for C > 1 a 24-byte record of each point's corners), and the maps a
# block takes at most
STAGE_BYTES = 96 * 1024
STAGE_MAPS = 8
POINT_RECORD_BYTES = 24
# fewer staged blocks than this (two an SM of an H100) leave SMs idle
# while each block stages its maps: such calls take the unit-stride layout
# where it applies (at a request's 100 coarse maps, 0.0054 against 0.0073
# ms on an H100; atomic_backward_probe.py part 13a)
STAGE_MIN_BLOCKS = 264
# the largest index the kernel computes in 32 bits (a block's width of
# headroom below 2^31)
INDEX_LIMIT = (1 << 31) - (1 << 20)
POINT_LAYOUTS = {'general': 0, 'staged': 1, 'unit': 2}


class PointSamplePlan(NamedTuple):
    """The forward kernel's layout for one call: ``layout`` a key of
    POINT_LAYOUTS; ``maps_per_block`` (staged); ``vec_copy``: the maps are
    staged by 16-byte copies (each dense in (H, W, C) order and aligned);
    ``wide``: 64-bit index math (unit); ``active_lanes``: the lanes of a
    warp that produce outputs (the general layout's last channel pass
    leaves lanes idle)."""
    layout: str
    maps_per_block: int = 1
    vec_copy: bool = False
    wide: bool = False
    active_lanes: float = 32.0


def point_sample_plan(shape, strides, dtype, k, address=0):
    """The layout of ``csrc/point_sample.cu``'s forward for maps of
    ``shape`` (N, C, H, W), element ``strides`` and ``dtype`` (float32 or
    bfloat16) sampled at K points a map, the maps' data at ``address``
    (its alignment decides the 16-byte loads):

    - 'staged' where one map's C x H x W elements (with a record of each
      point's corners where C > 1) fit in STAGE_BYTES of shared memory:
      up to STAGE_MAPS maps a block, copied once; unless that makes fewer
      than STAGE_MIN_BLOCKS blocks and the unit-stride layout applies;
    - 'unit' where the channel stride is 1, C and every other stride are
      multiples of a 16-byte vector's elements (8 bf16, 4 float32) and
      the data is 16-byte aligned: a lane a vector of channels;
    - 'general' otherwise: a warp a point, a lane a channel.

    Never the plain version."""
    n, c, h, w = (int(v) for v in shape)
    sn, sc, sy, sx = (int(v) for v in strides)
    size = 2 if dtype == torch.bfloat16 else 4
    inner = (c - 1) * sc + (h - 1) * sy + (w - 1) * sx
    map_bytes = -(-c * h * w * size // 16) * 16
    per_map = map_bytes + (k * POINT_RECORD_BYTES if c > 1 else 0)
    vec = 16 // size
    unit = sc == 1 and c % vec == 0 and address % 16 == 0 and \
        all(s % vec == 0 for s in (sn, sy, sx))
    if per_map <= STAGE_BYTES and inner < INDEX_LIMIT and \
            STAGE_MAPS * k * c < INDEX_LIMIT:
        maps = max(1, min(STAGE_MAPS, STAGE_BYTES // max(per_map, 1)))
        if not unit or -(-n // maps) >= STAGE_MIN_BLOCKS:
            dense = sx == c and sy == w * c and (c == 1 or sc == 1)
            vec_copy = dense and c * h * w * size % 16 == 0 and \
                sn * size % 16 == 0 and address % 16 == 0
            return PointSamplePlan('staged', maps, vec_copy)
    if unit:
        top = max(n * k * c, (n - 1) * sn + inner + 1)
        return PointSamplePlan('unit', wide=top >= INDEX_LIMIT)
    return PointSamplePlan('general', active_lanes=c / max(1, -(-c // 32)))


_plan = functools.lru_cache(maxsize=256)(point_sample_plan)
_FORWARD_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 +
                 [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5 +
                 [ctypes.c_void_p])


def point_sample_launch(maps, points, plan=None):
    """Launch ``erd_point_sample`` (CUDA tensors) in ``plan``'s layout
    (default: ``point_sample_plan``'s; a forced plan must fit the maps, or
    the kernel refuses it and this raises); counted in
    ``point_sample.launches``."""
    device, dtype = maps.device, maps.dtype
    if device.type != 'cuda':
        raise RuntimeError(f'point_sample: no kernel for {device}')
    if dtype is not torch.float32 and dtype is not torch.bfloat16:
        raise TypeError('point_sample: maps must be float32 or bfloat16')
    if points.dtype is not torch.float32 or points.device != device:
        raise TypeError('point_sample: float32 points on the maps\' device '
                        'expected')
    points = points.contiguous()
    shape, strides, address = maps.shape, maps.stride(), maps.data_ptr()
    n, c, h, w = shape
    k = points.shape[1]
    out = torch.empty((n, k, c), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = _plan(tuple(shape), strides, dtype, k, address % 16)
    fn = cuda_build.entry('point_sample', 'erd_point_sample', _FORWARD_ARGS)
    with cuda_build.on_device(device):
        err = fn(address, points.data_ptr(), out.data_ptr(), n, c, h, w, k,
                 *strides, int(dtype is torch.bfloat16),
                 POINT_LAYOUTS[plan.layout], plan.maps_per_block,
                 int(plan.vec_copy), int(plan.wide),
                 cuda_build.stream_handle(device))
    if err:
        cuda_build.check(cuda_build.load('point_sample'), err,
                         f'point_sample ({plan.layout})')
    point_sample.launches += 1
    return out


class _PointSample(torch.autograd.Function):
    """``point_sample`` with its gradient in the maps (the points take
    none): the plain versions for CPU tensors, the kernels for CUDA
    tensors."""

    @staticmethod
    def forward(ctx, points, align_corners, maps):
        ctx.save_for_backward(points)
        ctx.args = (tuple(maps.shape), maps.stride(), maps.dtype,
                    align_corners)
        if maps.device.type == 'cpu':
            return point_sample_plain(maps, points, align_corners)
        return point_sample_launch(maps, points)

    @staticmethod
    def backward(ctx, grad):
        points, = ctx.saved_tensors
        shape, strides, dtype, align_corners = ctx.args
        return None, None, point_sample_backward(
            grad.contiguous(), points, shape, strides, dtype, align_corners)


def point_sample(maps, points, align_corners=False):
    """Bilinear samples of ``maps`` at ``points``.

    Args:
        maps: (N, C, H, W) float32 or bfloat16, any strides.
        points: (N, K, 2) float32, (x, y) in [0, 1] of the map's extent; no
            gradient.
    Returns (N, K, C) float32, differentiable in ``maps``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if maps.dim() != 4 or points.dim() != 3 or points.shape[-1] != 2 or \
            points.shape[0] != maps.shape[0]:
        raise ValueError(f'point_sample: maps (N, C, H, W) and points (N, K, '
                         f'2) expected, got {tuple(maps.shape)} and '
                         f'{tuple(points.shape)}')
    kind = maps.device.type
    if kind not in ('cpu', 'cuda'):
        raise RuntimeError(f'point_sample: no kernel for {maps.device}')
    if kind == 'cuda' and align_corners:
        raise NotImplementedError('point_sample: align_corners=True has no '
                                  'kernel (no model path uses it)')
    grad = torch.is_grad_enabled()
    if grad and points.requires_grad:
        raise ValueError('point_sample: the points take no gradient; detach '
                         'them')
    if grad and maps.requires_grad:
        return _PointSample.apply(points, align_corners, maps)
    # no gradient to carry: the same forward, without autograd's Function
    if kind == 'cpu':
        return point_sample_plain(maps, points, align_corners)
    return point_sample_launch(maps, points)


point_sample.launches = 0


def point_sample_backward_plain(grad, points, shape, align_corners=False):
    """Plain PyTorch version of the backward kernel: grad (N, K, C) float32
    -> (N, C, H, W) float32 (float64 for a float64 grad), the transpose of
    ``point_sample_plain``'s four corner gathers: each corner on the map
    gets (g * its x weight) * its y weight, added with ``index_add_`` into
    the map's (N * H * W, C) pixel rows."""
    n, c, h, w = shape
    k = points.shape[1]
    g = grad.to(acc_dtype(grad.dtype))
    xs, ys = _sample_coords(points.to(g.dtype), h, w, align_corners)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    rows = torch.zeros((n * h * w, c), dtype=g.dtype, device=g.device)
    base = (torch.arange(n, device=g.device) * (h * w))[:, None]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for yy, xx, gy, gx in ((y0, x0, 1 - wy, 1 - wx), (y0, x0 + 1, 1 - wy, wx),
                           (y0 + 1, x0, wy, 1 - wx), (y0 + 1, x0 + 1, wy, wx)):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        rows.index_add_(0, idx.flatten(), torch.where(
            ok[..., None], g * gx * gy, zero).reshape(n * k, c))
    return rows.view(n, h, w, c).permute(0, 3, 1, 2)


def point_sample_backward(grad, points, shape, strides=None,
                          dtype=torch.float32, align_corners=False):
    """Gradient of ``point_sample`` in its maps.

    Args:
        grad: (N, K, C) float32, the gradient of the samples.
        points: the (N, K, 2) points of the forward call.
        shape, strides: the maps' (N, C, H, W) and element strides (None:
            contiguous).
        dtype: the maps' dtype, float32 or bfloat16.
    Returns (N, C, H, W) in ``dtype`` with the maps' strides: float32 sums,
    each rounded once to ``dtype`` (the transpose of erd_tpu's
    ``astype(float32)``).

    CPU tensors take the plain version; CUDA tensors launch the kernels
    of ``erd_point_sample_backward`` (one call, counted in
    ``point_sample_backward.launches``): each tile of pixels gathers its
    points' weighted gradients in a fixed order and is written once, so
    the result is the same every run; no float atomics, no float32 buffer
    (an int32 workspace where maps are binned by tile).
    """
    n, c, h, w = shape
    if grad.dim() != 3 or tuple(grad.shape) != (n, points.shape[1], c) or \
            points.shape[0] != n:
        raise ValueError(f'point_sample_backward: grad (N, K, C) and points '
                         f'(N, K, 2) of maps {tuple(shape)} expected, got '
                         f'{tuple(grad.shape)} and {tuple(points.shape)}')
    if strides is None:
        strides = torch.empty(shape, device='meta').stride()
    if grad.device.type == 'cpu':
        out = point_sample_backward_plain(grad, points, shape, align_corners)
        return torch.empty_strided(shape, strides, dtype=dtype).copy_(out)
    if grad.device.type != 'cuda':
        raise RuntimeError(f'point_sample_backward: no kernel for '
                           f'{grad.device}')
    if align_corners:
        raise NotImplementedError('point_sample_backward: align_corners=True '
                                  'has no kernel (no model path uses it)')
    if grad.dtype != torch.float32 or points.dtype != torch.float32 or \
            dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('point_sample_backward: float32 grad and points, '
                        'float32 or bfloat16 maps expected')
    k = points.shape[1]
    if n * k >= 1 << 29:
        raise ValueError(f'point_sample_backward: {n * k} points; the kernel '
                         f'takes fewer than 2^29 (4 int32 list entries a '
                         f'point)')
    out = torch.empty_strided(shape, strides, dtype=dtype,
                              device=grad.device)
    if n * k == 0 or out.numel() == 0:
        return out.zero_()
    grad, points = grad.contiguous(), points.contiguous()
    lib = cuda_build.load('point_sample')
    size = lib.erd_point_sample_backward_workspace
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    work = torch.empty(size(n, c, h, w, k), dtype=torch.int32,
                       device=grad.device)
    fn = lib.erd_point_sample_backward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 +
                   [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(grad.data_ptr(), points.data_ptr(), out.data_ptr(),
                 work.data_ptr(), n, c, h, w, k, *out.stride(),
                 int(dtype == torch.bfloat16), stream)
    cuda_build.check(lib, err, 'point_sample_backward')
    point_sample_backward.launches += 1
    return out


point_sample_backward.launches = 0


def _masked_conv_args(x, mask, weight, bias, stride):
    """(padding, (Ho, Wo)) of a masked conv, or raise on the shapes."""
    if x.dim() != 4 or weight.dim() != 4 or \
            weight.shape[1] != x.shape[1] or \
            weight.shape[2] != weight.shape[3]:
        raise ValueError(f'masked_conv2d: x (B, Cin, H, W) and a square '
                         f'weight (Co, Cin, K, K) expected, got '
                         f'{tuple(x.shape)} and {tuple(weight.shape)}')
    k = weight.shape[-1]
    pad = (k - 1) // 2
    out_hw = tuple((n + 2 * pad - k) // stride + 1 for n in x.shape[2:])
    if tuple(mask.shape) != (x.shape[0],) + out_hw:
        raise ValueError(f'masked_conv2d: mask {tuple(mask.shape)} for an '
                         f'output of {(x.shape[0],) + out_hw}')
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f'masked_conv2d: bias {tuple(bias.shape)} for '
                         f'{weight.shape[0]} output channels')
    return pad, out_hw


def masked_conv2d_plain(x, mask, weight, bias=None, stride=1):
    """Plain PyTorch version of the kernel: the dense float32 convolution
    (full float32, as ``conv2d_ieee``) plus bias, times the mask, as
    erd_tpu computes it."""
    pad, _ = _masked_conv_args(x, mask, weight, bias, stride)
    out = conv2d_ieee(x.float(), weight.float(),
                      None if bias is None else bias.float(),
                      (stride, stride), (pad, pad))
    return out * mask[:, None].to(out.dtype)


def masked_conv2d(x, mask, weight, bias=None, stride=1):
    """Masked convolution.

    Args:
        x: (B, Cin, H, W), computed in float32.
        mask: (B, Ho, Wo), bool or float; zero marks an output position
            left out (it reads 0).
        weight: (Co, Cin, K, K); bias: (Co,) or None.
        stride: the convolution's stride.
    Returns (B, Co, Ho, Wo) float32: (conv(x) + bias) * mask.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the positions where the mask is nonzero (one launch, counted in
    ``masked_conv2d.launches``).
    """
    _, (ho, wo) = _masked_conv_args(x, mask, weight, bias, stride)
    if x.device.type == 'cpu':
        return masked_conv2d_plain(x, mask, weight, bias, stride)
    if x.device.type != 'cuda' or any(
            t is not None and t.device != x.device
            for t in (mask, weight, bias)):
        raise RuntimeError(f'masked_conv2d: no kernel for {x.device}, or '
                           f'tensors on more than one device')
    flat = mask.reshape(-1)
    pos = torch.nonzero(flat).reshape(-1)
    return masked_conv_positions(
        x.float().contiguous(), weight.float().contiguous(),
        None if bias is None else bias.float().contiguous(),
        flat[pos].float().contiguous(), pos, stride, (ho, wo))


# the masked-conv kernel's tiles: (positions, channels) a block
MASKED_CONV_TILES = {1: (128, 128), 2: (64, 64), 3: (128, 256)}
# a tile's launch takes about a + b * n ms, n its blocks on the busiest SM:
# (a, b) fitted to a 3x3, 256 -> 256 conv at 19 values of P on an H100
# (erd_tpu_torch/tools/masked_conv_tiles.py); every tile's time scales
# alike with Cin * K^2
MASKED_CONV_TILE_COST = {1: (0.060, 0.242), 2: (0.057, 0.081),
                         3: (0.021, 0.477)}


def masked_conv_tile(p, co, sm_count):
    """The kernel's tile for P masked positions and Co output channels on
    a card of ``sm_count`` SMs: the one whose launch
    MASKED_CONV_TILE_COST puts shortest (128 x 256 only for Co > 128)."""
    def cost(tile):
        bm, bn = MASKED_CONV_TILES[tile]
        blocks = -(-p // bm) * -(-co // bn)
        a, b = MASKED_CONV_TILE_COST[tile]
        return a + b * max(1, -(-blocks // sm_count))
    return min((1, 2, 3) if co > 128 else (1, 2), key=cost)


def masked_conv_positions(x, weight, bias, maskv, pos, stride, out_hw,
                          tile=None):
    """Launch ``erd_masked_conv2d`` on compacted positions (CUDA tensors;
    the launch that ``masked_conv2d`` counts): x (B, Cin, H, W) float32,
    weight (Co, Cin, K, K) float32 (OIHW, contiguous), bias (Co,) or None,
    maskv (P,) float32 the mask's values at pos (P,) int64, flat indices
    into (B, Ho, Wo); ``tile`` a key of MASKED_CONV_TILES, or None for
    ``masked_conv_tile``'s. Returns the (B, Co, Ho, Wo) float32 output:
    those positions filled, every other one zero. No host synchronisation (P is
    pos's shape; CUDA-graph capturable)."""
    if x.device.type != 'cuda':
        raise RuntimeError(f'masked_conv_positions: no kernel for '
                           f'{x.device}')
    b, cin, h, w = x.shape
    co, k = weight.shape[0], weight.shape[-1]
    ho, wo = out_hw
    p = pos.numel()
    if tile is None:
        tile = masked_conv_tile(p, co, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    if tile not in MASKED_CONV_TILES:
        raise ValueError(f'masked_conv_positions: tile {tile} is not one '
                         f'of {tuple(MASKED_CONV_TILES)}')
    # the kernel writes every masked position; zero the rest (no memset
    # where every position is masked)
    out = (torch.empty if p == b * ho * wo else torch.zeros)(
        (b, co, ho, wo), dtype=torch.float32, device=x.device)
    if p == 0 or co == 0:
        return out
    # (Co, K, K, Cin): the kernel reduces tap-major, and reads each tap's
    # run of input channels with 16-byte loads
    w_ohwi = weight.permute(0, 2, 3, 1).contiguous()
    lib = cuda_build.load('masked_conv')
    fn = lib.erd_masked_conv2d
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w_ohwi.data_ptr(),
                 None if bias is None else bias.data_ptr(), maskv.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), p, cin, h, w, co, k, stride,
                 (k - 1) // 2, ho, wo, tile, stream)
    cuda_build.check(lib, err, 'masked_conv2d')
    masked_conv2d.launches += 1
    return out


masked_conv2d.launches = 0
