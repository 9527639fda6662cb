"""Fixed-shape selection helpers for dense-head post-processing; the
counterpart of erd_tpu/ops/misc.py.

Top-k is a stable descending sort cut to k, in ``lax.top_k``'s order:
floats in IEEE totalOrder (NaN first, +0 before -0), equal values lowest
index first; ``torch.topk`` promises no order for ties. The order matters:
when fewer than k entries pass the threshold, the -inf ties decide which
rows fill the invalid slots, and those rows still feed the class offset of
the batched NMS.
"""
from __future__ import annotations

import torch

NEG_INF = float('-inf')


def topk_stable(values, k):
    """Top-k along the last dim in ``lax.top_k``'s order: floats ranked in
    IEEE totalOrder (NaN first, +0 before -0; bf16 and half keyed through
    their exact float32 values), integers as they are, ties lowest index
    first. Returns (values (..., k), idx (..., k) int64)."""
    key = values
    if values.is_floating_point():
        key = total_order_key(values if values.dtype == torch.float64
                              else values.float())
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(values, -1, idx), idx


def take_rows(a, idx):
    """Gather ``a`` (..., N, *rest) at ``idx`` (..., k) along the N dim."""
    extra = a.dim() - idx.dim()
    full = idx.reshape(idx.shape + (1,) * extra)
    return torch.take_along_dim(a, full, dim=idx.dim() - 1)


def filter_scores_and_topk(scores, score_thr, topk):
    """Threshold (..., N, C) scores, then take the top-k (anchor, class)
    pairs of each leading index.

    Returns (top_scores (..., k), labels, anchor_idx, mask); invalid slots
    carry score 0 and mask False.
    """
    n, c = scores.shape[-2:]
    flat = scores.reshape(*scores.shape[:-2], n * c)
    masked = torch.where(flat > score_thr, flat,
                         torch.full_like(flat, NEG_INF))
    k = min(topk, n * c) if topk > 0 else n * c
    top_scores, top_idx = topk_stable(masked, k)
    mask = top_scores > NEG_INF
    anchor_idx = torch.div(top_idx, c, rounding_mode='floor')
    labels = top_idx % c
    top_scores = torch.where(mask, top_scores, torch.zeros_like(top_scores))
    return top_scores, labels, anchor_idx, mask


def cap_candidates(scores, valid, k, *arrays):
    """Keep the top-``k`` valid entries by score along the last dim of
    ``scores``; gather the companion arrays along the same dim.

    Returns (scores (..., k), valid (..., k), *gathered arrays).
    """
    k = min(k, scores.shape[-1])
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top, idx = topk_stable(masked, k)
    new_valid = top > NEG_INF
    out = [torch.where(new_valid, top, torch.zeros_like(top)), new_valid]
    out.extend(take_rows(a, idx) for a in arrays)
    return tuple(out)


def total_order_key(x):
    """Integer keys of float32 / float64 ``x`` in IEEE totalOrder (-0 before
    +0), the order in which ``lax.top_k`` ranks floats: int32 keys for
    float32 (a 4-byte sort, as the values' own), int64 for float64."""
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}[x.dtype]
    i = x.contiguous().view(bits)
    return torch.where(i < 0, -(i & torch.iinfo(bits).max) - 1, i)


def topk_mask_select(criterion, cap, threshold):
    """Select entries with ``criterion > threshold``, capped at ``cap``:
    the top-``cap`` entries along the last dim (lax.top_k's order: ties
    lowest index first, +0 before -0) and a mask of those above
    ``threshold``, which broadcasts against the leading dims. Returns (idx
    (..., cap) int64, mask (..., cap) bool)."""
    k = min(cap, criterion.shape[-1])
    top_idx = torch.sort(total_order_key(criterion), dim=-1, descending=True,
                         stable=True)[1][..., :k]
    return top_idx, torch.gather(criterion, -1, top_idx) > threshold


def masked_mean_std(x, mask, ddof=1, eps=1e-12):
    """Mean and sample std over the masked entries of the last dim
    (torch ``.std()`` uses ddof 1); std = sqrt(max(var, eps))."""
    mask = mask.to(x.dtype)
    cnt = mask.sum(dim=-1).clamp(min=1.0)
    mean = (x * mask).sum(dim=-1) / cnt
    var = ((x - mean[..., None]).square() * mask).sum(dim=-1) / \
        (cnt - ddof).clamp(min=1.0)
    return mean, var.clamp(min=eps).sqrt()
