"""ATSS assignment, batched; the counterpart of erd_tpu/task/atss.py.

``atss_assign`` takes the plain PyTorch version below for CPU tensors and
launches the kernel ``csrc/atss.cu`` for CUDA tensors. Both follow
erd_tpu's static-shape formulation for each (image, gt):

  * per level, the ``min(topk, level size)`` anchors whose centres lie
    nearest the gt centre (distance sqrt(dx*dx + dy*dy); invalid anchors at
    INF = 1e8; equal distances lowest anchor index first, as lax.top_k);
  * threshold = mean + sample std (ddof 1) of the candidates' IoUs, over
    the candidates backed by a valid anchor, summed slot by slot in
    candidate order (level, then distance);
  * positive: IoU >= threshold, valid, centre inside the gt by more than
    0.01 on every side, and a real (unpadded) gt;
  * an anchor positive for several gts takes the one of largest IoU, the
    lowest gt index among equals.

The sums are taken one slot at a time in both versions, so the kernel and
the plain version round alike and agree exactly.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops import cuda_build
from ..structures.boxes import bbox_center, bbox_overlaps

INF = 1e8


@dataclass
class AssignResult:
    """Dense assignment over N anchors of each image, all (B, N):
    pos_mask bool; gt_idx int64 (0 where negative); max_overlaps float32
    (-INF where negative); labels int64 (-1 where negative)."""
    pos_mask: torch.Tensor
    gt_idx: torch.Tensor
    max_overlaps: torch.Tensor
    labels: torch.Tensor


def _seq_sum(x):
    """Sum over dim 1 one slot at a time, from slot 0 (fixed rounding)."""
    total = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        total = total + x[:, k]
    return total


def atss_assign_plain(anchors, num_level_anchors: Sequence[int], gt_bboxes,
                      gt_labels, gt_mask, valid_flags, topk=9):
    """Plain PyTorch version of the ATSS kernel (same arguments)."""
    b, g = gt_bboxes.shape[:2]
    n = anchors.shape[0]
    overlaps = bbox_overlaps(anchors.expand(b, n, 4), gt_bboxes)  # (B, N, G)
    a_ctr = bbox_center(anchors)  # (N, 2)
    g_ctr = bbox_center(gt_bboxes)  # (B, G, 2)
    diff = a_ctr[None, :, None, :] - g_ctr[:, None, :, :]
    dist = (diff[..., 0].square() + diff[..., 1].square()).sqrt()
    dist = torch.where(valid_flags[..., None], dist,
                       torch.full_like(dist, INF))

    cand_idx, cand_d = [], []
    start = 0
    for n_lvl in num_level_anchors:
        k = min(topk, n_lvl)
        d_sorted, idx = torch.sort(dist[:, start:start + n_lvl], dim=1,
                                   stable=True)
        cand_idx.append(idx[:, :k] + start)
        cand_d.append(d_sorted[:, :k])
        start += n_lvl
    cand_idx = torch.cat(cand_idx, dim=1)  # (B, K, G)
    cand_valid = torch.cat(cand_d, dim=1) < INF
    cand_ov = torch.gather(overlaps, 1, cand_idx)

    cv = cand_valid.to(cand_ov.dtype)
    cnt = cv.sum(dim=1).clamp(min=1.0)
    mean = _seq_sum(cand_ov * cv) / cnt
    var = _seq_sum((cand_ov - mean[:, None]).square() * cv) / \
        (cnt - 1.0).clamp(min=1.0)
    thr = mean + var.clamp(min=0.0).sqrt()  # (B, G)

    cx = a_ctr[:, 0][cand_idx]
    cy = a_ctr[:, 1][cand_idx]
    gb = gt_bboxes[:, None]
    side = torch.minimum(torch.minimum(cx - gb[..., 0], cy - gb[..., 1]),
                         torch.minimum(gb[..., 2] - cx, gb[..., 3] - cy))
    is_pos = (cand_ov >= thr[:, None]) & cand_valid & (side > 0.01) & \
        gt_mask[:, None, :]

    pos_dense = torch.zeros((b, n, g), dtype=torch.bool,
                            device=anchors.device)
    pos_dense.scatter_(1, cand_idx, is_pos)
    sel = torch.where(pos_dense, overlaps, torch.full_like(overlaps, -INF))
    max_ov = sel.amax(dim=2)
    gt_idx = sel.argmax(dim=2)
    pos = max_ov > -INF
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         torch.full_like(gt_idx, -1))
    return AssignResult(pos_mask=pos, gt_idx=gt_idx, max_overlaps=max_ov,
                        labels=labels)


@functools.lru_cache(maxsize=16)
def _level_starts(num_level_anchors, device):
    """(L + 1,) int32 first anchor of each level on ``device``, uploaded
    once per canvas and device."""
    return torch.from_numpy(np.concatenate(
        [[0], np.cumsum(num_level_anchors)]).astype(np.int32)).to(device)


def atss_assign(anchors, num_level_anchors: Sequence[int], gt_bboxes,
                gt_labels, gt_mask, valid_flags, topk=9):
    """ATSS assignment of a batch of images to their padded ground truth.

    Args:
        anchors: (N, 4) float32 anchors of all levels.
        num_level_anchors: per-level anchor counts, summing to N.
        gt_bboxes: (B, G, 4) float32 padded gt boxes.
        gt_labels: (B, G) integer labels.
        gt_mask: (B, G) bool, False for padding slots.
        valid_flags: (B, N) bool anchor validity.
        topk: candidates per level and gt.
    Returns an AssignResult of (B, N) tensors.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    call, counted in ``atss_assign.launches``).
    """
    n = anchors.shape[0]
    if anchors.dim() != 2 or anchors.shape[1] != 4 or \
            sum(num_level_anchors) != n:
        raise ValueError('anchors must be (N, 4) with N = sum of the level '
                         'counts')
    if gt_bboxes.dim() != 3 or gt_bboxes.shape[-1] != 4:
        raise ValueError(f'gt_bboxes must be (B, G, 4), got '
                         f'{tuple(gt_bboxes.shape)}')
    b, g = gt_bboxes.shape[:2]
    if tuple(gt_labels.shape) != (b, g) or tuple(gt_mask.shape) != (b, g) \
            or tuple(valid_flags.shape) != (b, n):
        raise ValueError('gt_labels, gt_mask (B, G) and valid_flags (B, N) '
                         'expected')
    if anchors.device.type == 'cpu':
        return atss_assign_plain(anchors, num_level_anchors, gt_bboxes,
                                 gt_labels, gt_mask, valid_flags, topk)
    if anchors.device.type != 'cuda':
        raise RuntimeError(f'atss_assign: no kernel for {anchors.device}')
    dev = anchors.device
    if any(t.device != dev for t in (gt_bboxes, gt_labels, gt_mask,
                                     valid_flags)):
        raise ValueError('atss_assign: all tensors must be on one device')
    if anchors.dtype != torch.float32 or gt_bboxes.dtype != torch.float32:
        raise TypeError('atss_assign: anchors and gt_bboxes must be float32')
    if gt_mask.dtype != torch.bool or valid_flags.dtype != torch.bool:
        raise TypeError('atss_assign: gt_mask and valid_flags must be bool')
    if not 1 <= topk <= 32 or len(num_level_anchors) > 8:
        raise ValueError('atss_assign: the kernel takes topk <= 32 and at '
                         'most 8 levels')
    anchors = anchors.contiguous()
    gt_bboxes = gt_bboxes.contiguous()
    labels32 = gt_labels.to(torch.int32).contiguous()
    gt_mask = gt_mask.contiguous()
    valid_flags = valid_flags.contiguous()
    starts = _level_starts(tuple(num_level_anchors), dev)
    lib = cuda_build.load('atss')
    words = lib.erd_atss_workspace_words
    words.argtypes = [ctypes.c_int] * 5
    words.restype = ctypes.c_longlong
    best = torch.empty(words(b, n, g, len(num_level_anchors), topk),
                       dtype=torch.int64, device=dev)
    pos = torch.empty((b, n), dtype=torch.bool, device=dev)
    gt_idx = torch.empty((b, n), dtype=torch.int64, device=dev)
    max_ov = torch.empty((b, n), dtype=torch.float32, device=dev)
    labels = torch.empty((b, n), dtype=torch.int64, device=dev)
    fn = lib.erd_atss_assign
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(anchors.data_ptr(), starts.data_ptr(), gt_bboxes.data_ptr(),
                 labels32.data_ptr(), gt_mask.data_ptr(),
                 valid_flags.data_ptr(), b, n, g, len(num_level_anchors),
                 topk, best.data_ptr(), pos.data_ptr(), gt_idx.data_ptr(),
                 max_ov.data_ptr(), labels.data_ptr(), stream)
    cuda_build.check(lib, err, 'atss_assign')
    atss_assign.launches += 1
    return AssignResult(pos_mask=pos, gt_idx=gt_idx, max_overlaps=max_ov,
                        labels=labels)


atss_assign.launches = 0
