"""Fixed-shape greedy NMS; the counterpart of erd_tpu/ops/nms.py.

Every function takes one image ((K, 4) boxes) or a batch ((B, K, 4)). The
wrapper sorts by score (stable, descending), gathers the boxes and applies
the class offset; ``nms_sorted_keep`` then solves the greedy recursion

    alive[j] = valid[j] and not any(sup[i, j] and alive[i] for i < j)

over the sorted boxes, with sup[i, j] = j > i and valid[i] and
iou(i, j) > thr. For CUDA tensors that is the kernel ``csrc/nms.cu``; for CPU
tensors it is the plain version below, the reference's suppression matrix
and Jacobi fixpoint. Both round every IoU as the reference does, so keep
masks are bit-identical. ``set_nms_mask`` (CrowdDet) adds
sup[i, j] &= group[i] != group[j] and runs the same kernel with its group
test, through ``set_nms_sorted_keep``.

``soft_nms_select`` is the soft-NMS scan of erd_tpu's ``soft_nms_select``:
the wrapper masks and class-shifts, and ``soft_nms`` runs the steps, the
kernel ``csrc/soft_nms.cu`` for CUDA tensors and ``soft_nms_plain`` for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .misc import NEG_INF, take_rows, topk_stable


def _suppress_matrix(sboxes, svalid, iou_threshold):
    """(..., K, K) bool: keeping sorted box i removes sorted box j."""
    x1, y1, x2, y2 = sboxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :]) -
          torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :]) -
          torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    overlap = iw * ih
    union = (area[..., :, None] + area[..., None, :] - overlap).clamp(
        min=1e-6)
    iou = overlap / union
    k = sboxes.shape[-2]
    later = torch.ones((k, k), dtype=torch.bool,
                       device=sboxes.device).triu(diagonal=1)
    return (iou > iou_threshold) & later & svalid[..., :, None]


def _greedy_fixpoint(suppress, svalid):
    """Jacobi fixpoint of the greedy recursion; exact, at most K sweeps.

    The 0/1 products are exact in fp32 (sums of at most K < 2^24 ones).
    """
    sup = suppress.to(torch.float32)
    alive = svalid
    for _ in range(svalid.shape[-1]):
        hit = torch.matmul(alive.to(torch.float32).unsqueeze(-2),
                           sup).squeeze(-2) > 0
        new = svalid & ~hit
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def nms_sorted_keep_plain(sboxes, svalid, order, iou_threshold):
    """Plain PyTorch version of the NMS kernel (same arguments)."""
    alive = _greedy_fixpoint(
        _suppress_matrix(sboxes, svalid, iou_threshold), svalid)
    keep = torch.zeros_like(svalid)
    return keep.scatter(-1, order, alive)


def set_nms_sorted_keep_plain(sboxes, svalid, sgroup, order, iou_threshold):
    """Plain PyTorch version of the set-NMS kernel (same arguments):
    erd_tpu's suppression matrix masked where the groups are equal."""
    sup = _suppress_matrix(sboxes, svalid, iou_threshold) & \
        (sgroup[..., :, None] != sgroup[..., None, :])
    alive = _greedy_fixpoint(sup, svalid)
    return torch.zeros_like(svalid).scatter(-1, order, alive)


def _check_sorted(what, sboxes, svalid, order, sgroup=None):
    """Shapes of the sorted-NMS arguments; on the card, also their device,
    dtypes and contiguity."""
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4:
        raise ValueError(f'{what}: sboxes must be (B, K, 4), got '
                         f'{tuple(sboxes.shape)}')
    b, k = sboxes.shape[:2]
    rest = [svalid, order] + ([] if sgroup is None else [sgroup])
    if any(tuple(t.shape) != (b, k) for t in rest):
        raise ValueError(f'{what}: svalid, order (and sgroup) must be (B, K)')
    if sboxes.device.type == 'cpu':
        return
    if sboxes.device.type != 'cuda':
        raise RuntimeError(f'{what}: no kernel for {sboxes.device}')
    if any(t.device != sboxes.device for t in rest):
        raise ValueError(f'{what}: all tensors must be on one device')
    if sboxes.dtype != torch.float32 or svalid.dtype != torch.bool or \
            order.dtype != torch.int64 or \
            (sgroup is not None and sgroup.dtype != torch.int64):
        raise TypeError(f'{what}: sboxes float32, svalid bool, order (and '
                        f'sgroup) int64 expected')
    if not all(t.is_contiguous() for t in [sboxes] + rest):
        raise ValueError(f'{what}: tensors must be contiguous')


def _nms_kernel(what, sboxes, svalid, sgroup, order, iou_threshold):
    """One launch of csrc/nms.cu (the bitmask and the reduce kernel); a
    null group is plain NMS."""
    b, k = sboxes.shape[:2]
    words = (k + 63) // 64
    mask = torch.empty((b, k, words), dtype=torch.int64, device=sboxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=sboxes.device)
    lib = cuda_build.load('nms')
    fn = lib.erd_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(sboxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sboxes.data_ptr(), svalid.data_ptr(),
                 None if sgroup is None else sgroup.data_ptr(),
                 order.data_ptr(), mask.data_ptr(), keep.data_ptr(), b, k,
                 float(iou_threshold), stream)
    cuda_build.check(lib, err, what)
    return keep


def nms_sorted_keep(sboxes, svalid, order, iou_threshold):
    """Greedy-NMS keep mask of score-sorted boxes, in the original order.

    Args:
        sboxes: (B, K, 4) fp32 xyxy, sorted by descending score (and
            class-shifted for class-aware NMS).
        svalid: (B, K) bool validity of the sorted entries.
        order: (B, K) int64, order[b, i] = original index of sorted entry i.
        iou_threshold: float; a box is removed when IoU > threshold.
    Returns keep (B, K) bool in the original order.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    call = the bitmask and the reduce launch, counted in
    ``nms_sorted_keep.launches``).
    """
    _check_sorted('nms_sorted_keep', sboxes, svalid, order)
    if sboxes.device.type == 'cpu':
        return nms_sorted_keep_plain(sboxes, svalid, order, iou_threshold)
    keep = _nms_kernel('nms_sorted_keep', sboxes, svalid, None, order,
                       iou_threshold)
    nms_sorted_keep.launches += 1
    return keep


nms_sorted_keep.launches = 0


def set_nms_sorted_keep(sboxes, svalid, sgroup, order, iou_threshold):
    """Set-NMS keep mask of score-sorted boxes, in the original order:
    ``nms_sorted_keep`` with ``sgroup`` (B, K) int64, the sorted group ids;
    two boxes of one group never suppress each other.

    CPU tensors take the plain version; CUDA tensors launch the NMS kernel
    with its group test (counted in ``set_nms_sorted_keep.launches``, not in
    ``nms_sorted_keep.launches``).
    """
    _check_sorted('set_nms_sorted_keep', sboxes, svalid, order, sgroup)
    if sboxes.device.type == 'cpu':
        return set_nms_sorted_keep_plain(sboxes, svalid, sgroup, order,
                                         iou_threshold)
    keep = _nms_kernel('set_nms_sorted_keep', sboxes, svalid, sgroup, order,
                       iou_threshold)
    set_nms_sorted_keep.launches += 1
    return keep


set_nms_sorted_keep.launches = 0


def _batched(fn):
    """Run ``fn`` on a batch; a single image gets a batch dim of 1."""
    def wrapper(boxes, *args, **kwargs):
        if boxes.dim() == 3:
            return fn(boxes, *args, **kwargs)
        args = [a.unsqueeze(0) if torch.is_tensor(a) else a for a in args]
        kwargs = {k: v.unsqueeze(0) if torch.is_tensor(v) else v
                  for k, v in kwargs.items()}
        out = fn(boxes.unsqueeze(0), *args, **kwargs)
        if isinstance(out, tuple):
            return tuple(o[0] for o in out)
        return out[0]
    wrapper.__doc__ = fn.__doc__
    wrapper.__name__ = fn.__name__
    return wrapper


@_batched
def nms_mask(boxes, scores, iou_threshold, valid_mask=None):
    """Greedy NMS keep mask over the input order.

    boxes (..., K, 4) xyxy; scores (..., K); invalid entries (score -inf or
    ``valid_mask`` False) are never kept and never suppress others.
    """
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores,
                             torch.full_like(scores, NEG_INF))
    sorted_scores, order = torch.sort(scores, dim=-1, descending=True,
                                      stable=True)
    sboxes = take_rows(boxes, order).contiguous()
    svalid = sorted_scores > NEG_INF
    return nms_sorted_keep(sboxes, svalid.contiguous(), order.contiguous(),
                           iou_threshold)


@_batched
def set_nms_mask(boxes, scores, group_ids, iou_threshold, valid_mask=None):
    """Set-NMS (CrowdDet) keep mask over the input order: class-agnostic
    greedy NMS after a stable descending sort, except that two boxes with
    the same ``group_ids`` entry never suppress each other.

    boxes (..., K, 4) xyxy; scores (..., K); group_ids (..., K) int;
    invalid entries (score -inf or ``valid_mask`` False) are never kept and
    never suppress others.
    """
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores,
                             torch.full_like(scores, NEG_INF))
    sorted_scores, order = torch.sort(scores, dim=-1, descending=True,
                                      stable=True)
    sboxes = take_rows(boxes, order).contiguous()
    sgroup = torch.gather(group_ids.to(torch.int64), -1, order)
    return set_nms_sorted_keep(sboxes, (sorted_scores > NEG_INF).contiguous(),
                               sgroup.contiguous(), order.contiguous(),
                               iou_threshold)


@_batched
def batched_nms_mask(boxes, scores, idxs, iou_threshold, valid_mask=None):
    """Class-aware NMS by the coordinate-offset trick (mmcv batched_nms).

    The offset is (max over ALL finite coordinates of the image, valid or
    not, + 1) times the class index, as erd_tpu/ops/nms.py computes it.
    """
    finite = torch.where(torch.isfinite(boxes), boxes,
                         torch.zeros_like(boxes))
    max_coord = finite.amax(dim=(-2, -1), keepdim=True)[..., 0]  # (B, 1)
    offsets = idxs.to(boxes.dtype) * (max_coord + 1)
    shifted = boxes + offsets[..., None]
    return nms_mask(shifted, scores, iou_threshold, valid_mask)


@_batched
def nms_select(boxes, scores, labels, iou_threshold, max_out,
               valid_mask=None, class_agnostic=False):
    """Batched NMS, then the top ``max_out`` kept detections by score.

    Returns (boxes (..., max_out, 4), scores, labels, mask), empty slots
    zeroed.
    """
    if class_agnostic:
        keep = nms_mask(boxes, scores, iou_threshold, valid_mask)
    else:
        keep = batched_nms_mask(boxes, scores, labels, iou_threshold,
                                valid_mask)
    kept_scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    k = min(max_out, kept_scores.shape[-1])
    top_scores, top_idx = topk_stable(kept_scores, k)
    out_mask = top_scores > NEG_INF
    out_boxes = torch.where(out_mask[..., None], take_rows(boxes, top_idx),
                            torch.zeros((), dtype=boxes.dtype,
                                        device=boxes.device))
    out_labels = torch.where(out_mask, take_rows(labels, top_idx),
                             torch.zeros_like(top_idx, dtype=labels.dtype))
    out_scores = torch.where(out_mask, top_scores,
                             torch.zeros_like(top_scores))
    if k < max_out:  # fewer candidates than capacity: pad to max_out
        pad = max_out - k
        lead = out_scores.shape[:-1]
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(
            lead + (pad, 4))], dim=-2)
        out_scores = torch.cat([out_scores, out_scores.new_zeros(
            lead + (pad,))], dim=-1)
        out_labels = torch.cat([out_labels, out_labels.new_zeros(
            lead + (pad,))], dim=-1)
        out_mask = torch.cat([out_mask, out_mask.new_zeros(lead + (pad,))],
                             dim=-1)
    return out_boxes, out_scores, out_labels, out_mask


_SOFT_METHODS = ('linear', 'gaussian')


def soft_nms_plain(sboxes, scores, steps, iou_threshold, sigma, min_score,
                   method):
    """Plain PyTorch version of the soft-NMS kernel (same arguments): the
    reference's scan, batched over images."""
    x1, y1, x2, y2 = sboxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    cur = scores.clone()
    neg_inf = torch.full_like(cur, NEG_INF)
    idx, sel = [], []
    for _ in range(steps):
        i = torch.argmax(cur, dim=-1, keepdim=True)  # first maximum
        idx.append(i)
        sel.append(torch.gather(cur, -1, i))

        def at(v):
            return torch.gather(v, -1, i)
        iw = (torch.minimum(at(x2), x2) - torch.maximum(at(x1), x1)).clamp(
            min=0)
        ih = (torch.minimum(at(y2), y2) - torch.maximum(at(y1), y1)).clamp(
            min=0)
        overlap = iw * ih
        iou = overlap / (at(area) + area - overlap).clamp(min=1e-6)
        if method == 'gaussian':
            # a tensor divisor: IEEE division on the card too
            w = torch.exp(-(iou * iou) / torch.full_like(iou, sigma))
        else:
            w = torch.where(iou > iou_threshold, 1.0 - iou,
                            torch.ones_like(iou))
        nxt = torch.where(cur > NEG_INF, cur * w, cur)
        nxt = torch.where(nxt < min_score, neg_inf, nxt)
        cur = nxt.scatter(-1, i, NEG_INF)
    return torch.cat(idx, dim=-1), torch.cat(sel, dim=-1)


def soft_nms(sboxes, scores, steps, iou_threshold=0.3, sigma=0.5,
             min_score=1e-3, method='linear'):
    """The first ``steps`` selections of the soft-NMS scan.

    Args:
        sboxes: (B, K, 4) fp32 xyxy, class-shifted for class-aware soft-NMS.
        scores: (B, K) fp32 scores, -inf for entries that take no part.
        steps: number of scan steps, at most K.
        method: 'linear' (w = 1 - iou where iou > iou_threshold) or
            'gaussian' (w = exp(-iou^2 / sigma)).
    Returns (idx (B, steps) int64, score (B, steps) fp32): the selected
    entry of each step and its decayed score at selection.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch for the batch, counted in ``soft_nms.launches``), which holds
    up to ``erd_soft_nms_max_k()`` candidates in shared memory and any
    larger K in a device-memory scratch.
    """
    if method not in _SOFT_METHODS:
        raise ValueError(f'soft-NMS method must be one of {_SOFT_METHODS}')
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4:
        raise ValueError(f'sboxes must be (B, K, 4), got '
                         f'{tuple(sboxes.shape)}')
    b, k = sboxes.shape[:2]
    if tuple(scores.shape) != (b, k):
        raise ValueError('scores must be (B, K)')
    if not 0 <= steps <= k:
        raise ValueError(f'steps must lie in [0, K={k}], got {steps}')
    if sboxes.device.type == 'cpu':
        return soft_nms_plain(sboxes, scores, steps, iou_threshold, sigma,
                              min_score, method)
    if sboxes.device.type != 'cuda':
        raise RuntimeError(f'soft_nms: no kernel for {sboxes.device}')
    if scores.device != sboxes.device:
        raise ValueError('soft_nms: all tensors must be on one device')
    if sboxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError('soft_nms: sboxes and scores must be float32')
    if not (sboxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError('soft_nms: tensors must be contiguous')
    lib = cuda_build.load('soft_nms')
    lib.erd_soft_nms_max_k.restype = ctypes.c_int
    with torch.cuda.device(sboxes.device):
        # above one block's shared memory, the scores and areas go to a
        # (B, 2, K) scratch in device memory
        scratch = None if k <= lib.erd_soft_nms_max_k() else torch.empty(
            (b, 2, k), dtype=torch.float32, device=sboxes.device)
        idx = torch.empty((b, steps), dtype=torch.int64, device=sboxes.device)
        sel = torch.empty((b, steps), dtype=torch.float32,
                          device=sboxes.device)
        fn = lib.erd_soft_nms
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sboxes.data_ptr(), scores.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 idx.data_ptr(), sel.data_ptr(), b, k, steps,
                 float(iou_threshold), float(sigma), float(min_score),
                 int(method == 'gaussian'), stream)
    cuda_build.check(lib, err, 'soft_nms')
    soft_nms.launches += 1
    return idx, sel


soft_nms.launches = 0


@_batched
def soft_nms_select(boxes, scores, labels, max_out, iou_threshold=0.3,
                    sigma=0.5, min_score=1e-3, method='linear',
                    valid_mask=None, class_agnostic=False):
    """Soft-NMS (Bodla et al. 2017) as erd_tpu's fixed-shape scan.

    ``min(max_out, K)`` steps; each takes the highest current score, emits
    it, and decays the others by w(iou) (see ``soft_nms``); scores that fall
    below ``min_score`` drop out. Classes are kept apart by the coordinate
    offset of ``batched_nms_mask`` unless ``class_agnostic``.

    Returns (boxes (..., max_out, 4), scores, labels, mask): decayed scores
    in selection order, empty slots zeroed.
    """
    cur = scores.to(torch.float32)
    if valid_mask is not None:
        cur = torch.where(valid_mask, cur, torch.full_like(cur, NEG_INF))
    if class_agnostic:
        shifted = boxes
    else:
        finite = torch.where(torch.isfinite(boxes), boxes,
                             torch.zeros_like(boxes))
        max_coord = finite.amax(dim=(-2, -1), keepdim=True)[..., 0]
        shifted = boxes + (labels.to(boxes.dtype) * (max_coord + 1))[..., None]
    k = min(max_out, boxes.shape[-2])
    sel_idx, sel_scores = soft_nms(
        shifted.contiguous(), cur.contiguous(), k, iou_threshold, sigma,
        min_score, method)
    out_mask = sel_scores >= min_score
    out_boxes = torch.where(out_mask[..., None], take_rows(boxes, sel_idx),
                            torch.zeros((), dtype=boxes.dtype,
                                        device=boxes.device))
    out_scores = torch.where(out_mask, sel_scores,
                             torch.zeros_like(sel_scores))
    out_labels = torch.where(out_mask, take_rows(labels, sel_idx),
                             torch.zeros_like(sel_idx, dtype=labels.dtype))
    if k < max_out:
        pad = max_out - k
        lead = out_scores.shape[:-1]
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(
            lead + (pad, 4))], dim=-2)
        out_scores = torch.cat([out_scores, out_scores.new_zeros(
            lead + (pad,))], dim=-1)
        out_labels = torch.cat([out_labels, out_labels.new_zeros(
            lead + (pad,))], dim=-1)
        out_mask = torch.cat([out_mask, out_mask.new_zeros(lead + (pad,))],
                             dim=-1)
    return out_boxes, out_scores, out_labels, out_mask


def nms_select_cfg(boxes, scores, labels, cfg, valid_mask=None,
                   class_agnostic=False):
    """Dispatch hard vs soft NMS from a GFLTestConfig-like ``cfg``
    (``nms_type``, ``iou_threshold``, ``soft_nms_*``, ``max_per_img``)."""
    if getattr(cfg, 'nms_type', 'nms') == 'soft_nms':
        return soft_nms_select(
            boxes, scores, labels, cfg.max_per_img,
            iou_threshold=cfg.iou_threshold, sigma=cfg.soft_nms_sigma,
            min_score=cfg.soft_nms_min_score, method=cfg.soft_nms_method,
            valid_mask=valid_mask, class_agnostic=class_agnostic)
    return nms_select(boxes, scores, labels, cfg.iou_threshold,
                      cfg.max_per_img, valid_mask=valid_mask,
                      class_agnostic=class_agnostic)
