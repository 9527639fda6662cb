"""The counterparts of erd_tpu/ops/extra_nms.py: corner pooling
(CornerNet's running maxima), matrix NMS (SOLO's soft score decay), fast NMS
(YOLACT's one-pass suppression) and nms_match (greedy NMS grouping). Each
runs a hand-written kernel on CUDA tensors and its plain PyTorch version on
CPU tensors.

``corner_pool(x, direction)``: each pixel takes the max over a ray of its
row or column, itself included. ``top`` takes everything below it (the scan
runs upward), ``bottom`` everything above it, ``left`` everything to its
right and ``right`` everything to its left, as mmcv's TopPool etc. and
erd_tpu's flipped ``lax.cummax``. Maps are (B, C, H, W), and the output
has the input's dtype (a max is exact). The output is NCHW: a
channels-last map (the hourglass's, on the card) is read where it lies by
a kernel of its own, as a channels-last output slowed the convs after the
pools. CPU tensors take ``corner_pool_plain``
(``torch.cummax``); CUDA tensors launch the kernel ``csrc/corner_pool.cu``
(one launch per call, counted in ``corner_pool.launches``).

The gradient (``corner_pool_backward``) is erd_tpu's: JAX differentiates
``cummax`` through ``lax.associative_scan`` with ``lax.max`` as the combine,
and ``lax.max`` gives half of the tangent to each of two tied operands, so a
tied run of a ray shares its outputs' gradients by the scan's tree, not by
position (``torch.cummax``'s own backward sends each output's gradient to
one index: a different function wherever a ReLU'd input ties). The plain
version replays JAX's recursion with ``balanced_max`` (``torch.maximum``
with ``lax.max``'s derivative: 1 to the operand equal to the output, 0.5 to
each of two, 0 to both where the output is NaN) and takes its
vector-Jacobian product; the kernel walks the same tree. ``top`` and
``left`` run the tree over the flipped ray, as erd_tpu's
``flip(cummax(flip(x)))`` does. A NaN is carried forward by both passes,
as ``lax.cummax`` and ``torch.cummax`` carry it.

``matrix_decay(scores, iou, labels)`` is SOLOv2's mask-IoU decay
(erd_tpu/models/detectors/solov2.py:399-410) on a precomputed (N, N) IoU,
and ``matrix_nms(boxes, scores, labels)`` erd_tpu's box form, whose IoU the
kernel computes: each score times the min over j of f(decay_iou[i, j],
comp[j]), decay_iou[i, j] the IoU of i with a higher-scoring (strict ``>``)
j of its class, comp[j] j's own largest such IoU, f gaussian or linear.
``fast_nms`` keeps a box unless an earlier box of its class in the stable
descending score order overlaps it above the threshold. ``nms_match`` takes
row 1's greedy keep mask (``nms_mask``, csrc/nms.cu) and gives each valid
box its leader, the first highest-scoring kept box that overlaps it above
the threshold (-1 for none or an invalid slot). Their kernels are in
``csrc/extra_nms.cu``: one call of ``matrix_decay`` or ``matrix_nms`` is two
launches (comp, then the decay), both counted in ``matrix_decay.launches``
or ``matrix_nms.launches``; ``fast_nms_keep`` and ``nms_match_leader`` one
launch each. Every function takes one image ((N, ...) tensors) or a batch
((B, N, ...)).
"""
from __future__ import annotations

import ctypes

import torch

from ..structures.boxes import bbox_overlaps
from . import cuda_build
from .misc import NEG_INF, take_rows
from .nms import _batched, nms_mask
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
    """Launch ``erd_corner_pool`` (CUDA tensors) on x made NCHW, or
    ``erd_corner_pool_nhwc`` on a channels-last x where it lies; the output
    is NCHW. Counted in ``corner_pool.launches``."""
    dim, backward = _direction(direction)
    nhwc = not x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last)
    if not nhwc:
        x = x.contiguous()
    b, c, h, w = x.shape
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    sizes = (b, c, h, w) if nhwc else (b * c, h, w)
    lib = cuda_build.load('corner_pool')
    fn = lib.erd_corner_pool_nhwc if nhwc else lib.erd_corner_pool
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * (
        len(sizes) + 3) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), *sizes, int(dim == 3),
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


class _BalancedMax(torch.autograd.Function):
    """``torch.maximum`` (NaN wins) with JAX's ``_balanced_eq`` rule for
    ``lax.max``: an operand gets the tangent times 1 where it equals the
    output, 0.5 where the other operand equals it too, else 0 (a NaN output
    equals nothing, so neither operand gets any). torch's own rule sends
    the whole gradient of a NaN to both operands."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        a, b, out = ctx.saved_tensors

        def share(x, y):
            hit, both = x == out, y == out
            return torch.where(hit, torch.where(both, 0.5, 1.0), 0.0).to(
                grad.dtype)
        return grad * share(a, b), grad * share(b, a)


def balanced_max(a, b):
    """``torch.maximum(a, b)`` whose gradient is ``lax.max``'s."""
    return _BalancedMax.apply(a, b)


def scan_max(x, dim: int):
    """JAX's ``associative_scan(lax.max, x, axis=dim)`` in torch (dim >= 0):
    adjacent pairs combined, the half-length scan by recursion, the even
    outputs combined from the odd ones, the two interleaved
    (jax/_src/lax/control_flow/loops.py). Its values are ``torch.cummax``'s,
    NaN included; its autograd (``balanced_max``) is JAX's tree of tie
    splits."""
    n = x.shape[dim]
    if n < 2:
        return x

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    odd = scan_max(balanced_max(sl(x, 0, n - 1, 2), sl(x, 1, n, 2)), dim)
    even = balanced_max(sl(odd, 0, -1) if n % 2 == 0 else odd,
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


# ----------------------------------------------------------- matrix NMS
KERNELS = ('gaussian', 'linear')


def matrix_decay_plain(scores, iou, labels, sigma=2.0, kernel='gaussian'):
    """Plain PyTorch version of the matrix-decay kernel: scores (..., N),
    iou (..., N, N) with iou[i, j] the overlap of i with j, labels (..., N)
    -> (..., N) decayed scores, SOLOv2's formula op for op
    (erd_tpu/models/detectors/solov2.py:404-410)."""
    if kernel not in KERNELS:
        raise ValueError(f'matrix NMS kernel must be one of {KERNELS}, got '
                         f'{kernel!r}')
    same = labels[..., :, None] == labels[..., None, :]
    higher = scores[..., None, :] > scores[..., :, None]
    decay_iou = torch.where(same & higher, iou, torch.zeros_like(iou))
    comp = decay_iou.amax(-1)[..., None, :]
    if kernel == 'gaussian':
        decay = torch.exp(-sigma * (decay_iou ** 2 - comp ** 2)).amin(-1)
    else:
        decay = ((1 - decay_iou) / (1 - comp).clamp(min=1e-6)).amin(-1)
    return scores * decay


def matrix_nms_plain(boxes, scores, labels, valid_mask=None, sigma=2.0,
                     kernel='gaussian'):
    """Plain PyTorch version of the box form: erd_tpu's ``matrix_nms``,
    the decay on ``bbox_overlaps(boxes, boxes).T``."""
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, torch.zeros_like(scores))
    iou = bbox_overlaps(boxes, boxes).transpose(-1, -2)
    return matrix_decay_plain(scores, iou, labels, sigma, kernel)


def _decay_kernel(what, scores, iou, boxes, labels, sigma, kernel):
    """One call of ``erd_matrix_decay`` (two launches) on (B, N) scores and
    either a (B, N, N) IoU or (B, N, 4) boxes."""
    if kernel not in KERNELS:
        raise ValueError(f'{what}: kernel must be one of {KERNELS}, got '
                         f'{kernel!r}')
    mat = iou if iou is not None else boxes
    if mat.device.type != 'cuda' or any(
            t.device != mat.device for t in (scores, labels)):
        raise RuntimeError(f'{what}: no kernel for {mat.device}, or tensors '
                           f'on more than one device')
    if mat.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f'{what}: float32 scores and IoU / boxes expected')
    b, n = scores.shape
    scores = scores.contiguous()
    labels = labels.to(torch.int64).contiguous()
    mat = mat.contiguous()
    comp = torch.empty_like(scores)
    out = torch.empty_like(scores)
    lib = cuda_build.load('extra_nms')
    fn = lib.erd_matrix_decay
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(scores.data_ptr(),
                 mat.data_ptr() if iou is not None else None,
                 mat.data_ptr() if iou is None else None, labels.data_ptr(),
                 comp.data_ptr(), out.data_ptr(), b, n, float(sigma),
                 int(kernel == 'linear'), stream)
    cuda_build.check(lib, err, what)
    return out


def _as_batch(t, dims):
    """``t`` with a leading batch dim when it has ``dims`` dims."""
    return t.unsqueeze(0) if t.dim() == dims else t


def matrix_decay(scores, iou, labels, sigma=2.0, kernel='gaussian'):
    """SOLOv2's matrix NMS on a precomputed IoU.

    Args:
        scores: (N,) or (B, N) float32.
        iou: (N, N) or (B, N, N) float32, iou[i, j] the overlap of i with j
            (SOLOv2's mask IoU).
        labels: (N,) or (B, N) integer classes.
        sigma, kernel: the gaussian's sigma, ``'gaussian'`` or ``'linear'``.
    Returns the decayed scores, shaped as ``scores``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one call, two launches, both counted in ``matrix_decay.launches``).
    """
    if iou.shape[-2:] != (scores.shape[-1],) * 2 or \
            labels.shape != scores.shape:
        raise ValueError(f'matrix_decay: scores (..., N), iou (..., N, N), '
                         f'labels (..., N) expected, got '
                         f'{tuple(scores.shape)}, {tuple(iou.shape)}, '
                         f'{tuple(labels.shape)}')
    if scores.device.type == 'cpu':
        return matrix_decay_plain(scores, iou, labels, sigma, kernel)
    out = _decay_kernel('matrix_decay', _as_batch(scores, 1),
                        _as_batch(iou, 2), None, _as_batch(labels, 1), sigma,
                        kernel)
    matrix_decay.launches += 2
    return out.reshape(scores.shape)


matrix_decay.launches = 0


def matrix_nms(boxes, scores, labels, valid_mask=None, sigma=2.0,
               kernel='gaussian'):
    """erd_tpu's ``matrix_nms``: decayed scores (same order) of boxes
    (..., N, 4) xyxy, scores and labels (..., N); ``valid_mask`` False
    zeroes a score first. The kernel computes the boxes' IoU itself.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one call, two launches, both counted in ``matrix_nms.launches``).
    """
    if boxes.shape[-1] != 4 or boxes.shape[:-1] != scores.shape or \
            labels.shape != scores.shape:
        raise ValueError(f'matrix_nms: boxes (..., N, 4), scores and labels '
                         f'(..., N) expected, got {tuple(boxes.shape)}, '
                         f'{tuple(scores.shape)}, {tuple(labels.shape)}')
    if boxes.device.type == 'cpu':
        return matrix_nms_plain(boxes, scores, labels, valid_mask, sigma,
                                kernel)
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, torch.zeros_like(scores))
    out = _decay_kernel('matrix_nms', _as_batch(scores, 1), None,
                        _as_batch(boxes, 2), _as_batch(labels, 1), sigma,
                        kernel)
    matrix_nms.launches += 2
    return out.reshape(scores.shape)


matrix_nms.launches = 0


# -------------------------------------------------------------- fast NMS
def fast_nms_keep_plain(sboxes, slabels, svalid, order, iou_threshold):
    """Plain PyTorch version of the fast-NMS kernel (the arguments of
    ``fast_nms_keep``): erd_tpu's upper-triangle suppression."""
    iou = bbox_overlaps(sboxes, sboxes)
    n = sboxes.shape[-2]
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=sboxes.device).triu(diagonal=1)
    same = slabels[..., :, None] == slabels[..., None, :]
    sup = torch.where(earlier & same, iou, torch.zeros_like(iou))
    keep_sorted = (sup.amax(-2) <= iou_threshold) & svalid
    return torch.zeros_like(svalid).scatter(-1, order, keep_sorted)


def fast_nms_keep(sboxes, slabels, svalid, order, iou_threshold):
    """Fast-NMS keep mask of score-sorted boxes, in the original order.

    Args:
        sboxes: (B, N, 4) float32, sorted by descending score (stable,
            invalid entries last).
        slabels: (B, N) int64 sorted classes; svalid (B, N) bool.
        order: (B, N) int64, the original index of sorted entry j.
        iou_threshold: j goes when an earlier box of its class overlaps it
            above this.
    Returns keep (B, N) bool in the original order.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``erd_fast_nms_keep`` (counted in ``fast_nms_keep.launches``).
    """
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4 or any(
            tuple(t.shape) != tuple(sboxes.shape[:2])
            for t in (slabels, svalid, order)):
        raise ValueError('fast_nms_keep: sboxes (B, N, 4), slabels, svalid '
                         'and order (B, N) expected')
    if sboxes.device.type == 'cpu':
        return fast_nms_keep_plain(sboxes, slabels, svalid, order,
                                   iou_threshold)
    if sboxes.device.type != 'cuda':
        raise RuntimeError(f'fast_nms_keep: no kernel for {sboxes.device}')
    if sboxes.dtype != torch.float32 or svalid.dtype != torch.bool or \
            order.dtype != torch.int64:
        raise TypeError('fast_nms_keep: float32 sboxes, bool svalid and '
                        'int64 order expected')
    b, n = svalid.shape
    keep = torch.empty((b, n), dtype=torch.bool, device=sboxes.device)
    sboxes, svalid, order = (t.contiguous() for t in (sboxes, svalid, order))
    slabels = slabels.to(torch.int64).contiguous()
    lib = cuda_build.load('extra_nms')
    fn = lib.erd_fast_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(sboxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sboxes.data_ptr(), slabels.data_ptr(), svalid.data_ptr(),
                 order.data_ptr(), keep.data_ptr(), b, n,
                 float(iou_threshold), stream)
    cuda_build.check(lib, err, 'fast_nms_keep')
    fast_nms_keep.launches += 1
    return keep


fast_nms_keep.launches = 0


@_batched
def fast_nms(boxes, scores, labels, iou_threshold=0.5, valid_mask=None):
    """erd_tpu's ``fast_nms`` (YOLACT): keep mask (..., N) bool over the
    input order. Scores sort stably descending (invalid ones, -inf or
    ``valid_mask`` False, last and never kept); a box goes when an earlier
    box of its class overlaps it above ``iou_threshold``, kept or not."""
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores,
                             torch.full_like(scores, NEG_INF))
    neg, order = torch.sort(-scores, dim=-1, stable=True)
    return fast_nms_keep(take_rows(boxes, order).contiguous(),
                         torch.gather(labels.to(torch.int64), -1, order),
                         neg < float('inf'), order, iou_threshold)


# ------------------------------------------------------------- nms_match
def nms_match_leader_plain(boxes, scores, keep, valid, iou_threshold):
    """Plain PyTorch version of the leader kernel (the arguments of
    ``nms_match_leader``): erd_tpu's candidate matrix and first argmax."""
    iou = bbox_overlaps(boxes, boxes)
    cand = keep[..., None, :] & (iou > iou_threshold) & valid[..., :, None]
    s = torch.where(cand, scores[..., None, :].expand_as(iou),
                    torch.full_like(iou, NEG_INF))
    leader = s.argmax(-1)
    has = torch.isfinite(s.amax(-1)) & valid
    return torch.where(has, leader, torch.full_like(leader, -1))


def nms_match_leader(boxes, scores, keep, valid, iou_threshold):
    """Each box's leader: the first highest-scoring kept box that overlaps
    it above ``iou_threshold`` (itself, where it is kept), -1 where there is
    none or the box is invalid.

    Args:
        boxes: (B, N, 4) float32 xyxy; scores (B, N) float32.
        keep: (B, N) bool greedy keep mask; valid (B, N) bool.
    Returns (B, N) int64.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``erd_nms_match_leader`` (counted in ``nms_match_leader.launches``).
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or any(
            tuple(t.shape) != tuple(boxes.shape[:2])
            for t in (scores, keep, valid)):
        raise ValueError('nms_match_leader: boxes (B, N, 4), scores, keep and '
                         'valid (B, N) expected')
    if boxes.device.type == 'cpu':
        return nms_match_leader_plain(boxes, scores, keep, valid,
                                      iou_threshold)
    if boxes.device.type != 'cuda':
        raise RuntimeError(f'nms_match_leader: no kernel for {boxes.device}')
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or \
            keep.dtype != torch.bool or valid.dtype != torch.bool:
        raise TypeError('nms_match_leader: float32 boxes and scores, bool '
                        'keep and valid expected')
    b, n = scores.shape
    leader = torch.empty((b, n), dtype=torch.int64, device=boxes.device)
    boxes, scores, keep, valid = (t.contiguous()
                                  for t in (boxes, scores, keep, valid))
    lib = cuda_build.load('extra_nms')
    fn = lib.erd_nms_match_leader
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                 valid.data_ptr(), leader.data_ptr(), b, n,
                 float(iou_threshold), stream)
    cuda_build.check(lib, err, 'nms_match_leader')
    nms_match_leader.launches += 1
    return leader


nms_match_leader.launches = 0


@_batched
def nms_match(boxes, scores, iou_threshold, valid_mask=None):
    """erd_tpu's ``nms_match`` (mmcv's greedy NMS grouping): (keep (..., N)
    bool, leader (..., N) int64). ``keep`` is row 1's greedy keep mask
    (``nms_mask``); ``leader[i]`` the kept box whose group box i joined,
    the first argmax by score over kept j with IoU(i, j) > threshold, -1
    for invalid slots."""
    if valid_mask is None:
        valid_mask = torch.ones(scores.shape, dtype=torch.bool,
                                device=scores.device)
    keep = nms_mask(boxes, scores, iou_threshold, valid_mask=valid_mask)
    return keep, nms_match_leader(boxes, scores, keep, valid_mask,
                                  iou_threshold)
