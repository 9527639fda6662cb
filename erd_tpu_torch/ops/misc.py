"""Fixed-shape selection helpers for dense-head post-processing; the
counterpart of erd_tpu/ops/misc.py.

Top-k is a stable descending sort cut to k: ``lax.top_k`` returns equal
values lowest index first, and ``torch.topk`` promises no order for ties.
The order matters: when fewer than k entries pass the threshold, the -inf
ties decide which rows fill the invalid slots, and those rows still feed the
class offset of the batched NMS.
"""
from __future__ import annotations

import torch

NEG_INF = float('-inf')


def topk_stable(values, k):
    """Top-k along the last dim, ties lowest index first (lax.top_k)."""
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


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
