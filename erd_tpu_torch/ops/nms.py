"""Fixed-shape greedy NMS; the counterpart of erd_tpu/ops/nms.py.

Every function takes one image ((K, 4) boxes) or a batch ((B, K, 4)). The
wrapper sorts by score (stable, descending), gathers the boxes and applies
the class offset; ``nms_sorted_keep`` then solves the greedy recursion

    alive[j] = valid[j] and not any(sup[i, j] and alive[i] for i < j)

over the sorted boxes, with sup[i, j] = j > i and valid[i] and
iou(i, j) > thr. For CUDA tensors that is the kernel ``csrc/nms.cu``; for CPU
tensors it is the plain version below, the reference's suppression matrix
and Jacobi fixpoint. Both round every IoU as the reference does, so keep
masks are bit-identical.
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
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4:
        raise ValueError(f'sboxes must be (B, K, 4), got '
                         f'{tuple(sboxes.shape)}')
    b, k = sboxes.shape[:2]
    if tuple(svalid.shape) != (b, k) or tuple(order.shape) != (b, k):
        raise ValueError('svalid and order must be (B, K)')
    if sboxes.device.type == 'cpu':
        return nms_sorted_keep_plain(sboxes, svalid, order, iou_threshold)
    if sboxes.device.type != 'cuda':
        raise RuntimeError(f'nms_sorted_keep: no kernel for {sboxes.device}')
    if svalid.device != sboxes.device or order.device != sboxes.device:
        raise ValueError('nms_sorted_keep: all tensors must be on one device')
    if sboxes.dtype != torch.float32 or svalid.dtype != torch.bool or \
            order.dtype != torch.int64:
        raise TypeError('nms_sorted_keep: sboxes float32, svalid bool, '
                        'order int64 expected')
    if not (sboxes.is_contiguous() and svalid.is_contiguous() and
            order.is_contiguous()):
        raise ValueError('nms_sorted_keep: tensors must be contiguous')
    words = (k + 63) // 64
    mask = torch.empty((b, k, words), dtype=torch.int64, device=sboxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=sboxes.device)
    lib = cuda_build.load('nms')
    fn = lib.erd_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(sboxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sboxes.data_ptr(), svalid.data_ptr(), order.data_ptr(),
                 mask.data_ptr(), keep.data_ptr(), b, k,
                 float(iou_threshold), stream)
    cuda_build.check(lib, err, 'nms_sorted_keep')
    nms_sorted_keep.launches += 1
    return keep


nms_sorted_keep.launches = 0


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


def soft_nms_select(*args, **kwargs):
    """Soft-NMS is not ported yet (ROADMAP, kernel queue: soft-NMS)."""
    raise NotImplementedError(
        'soft_nms_select is not ported yet: see ROADMAP.md, section 2, '
        'kernel row "soft-NMS and set-NMS"')


def nms_select_cfg(boxes, scores, labels, cfg, valid_mask=None,
                   class_agnostic=False):
    """Dispatch hard vs soft NMS from a GFLTestConfig-like ``cfg``."""
    if getattr(cfg, 'nms_type', 'nms') == 'soft_nms':
        return soft_nms_select(boxes, scores, labels, cfg.max_per_img)
    return nms_select(boxes, scores, labels, cfg.iou_threshold,
                      cfg.max_per_img, valid_mask=valid_mask,
                      class_agnostic=class_agnostic)
