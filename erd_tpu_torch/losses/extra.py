"""CornerNet's losses; the counterparts of ``gaussian_focal_loss`` and
``associative_embedding_loss`` in erd_tpu/losses/extra.py."""
from __future__ import annotations

import torch

from .utils import weight_reduce_loss


def gaussian_focal_loss(pred, gaussian_target, weight=None, alpha=2.0,
                        gamma=4.0, reduction='mean', avg_factor=None):
    """CornerNet / CenterNet focal loss of probabilities ``pred`` against a
    gaussian heatmap: -log(p + eps) (1 - p)^alpha at the exact-1 peaks,
    -log(1 - p + eps) p^alpha (1 - target)^gamma elsewhere (eps 1e-12)."""
    eps = 1e-12
    pos = (gaussian_target == 1).to(pred.dtype)
    neg = torch.pow(1 - gaussian_target, gamma)
    pos_loss = -torch.log(pred + eps) * torch.pow(1 - pred, alpha) * pos
    neg_loss = -torch.log(1 - pred + eps) * torch.pow(pred, alpha) * neg * \
        (1 - pos)
    return weight_reduce_loss(pos_loss + neg_loss, weight, reduction,
                              avg_factor)


def associative_embedding_loss(tl_emb, br_emb, valid_mask, pull_weight=0.25,
                               push_weight=0.25):
    """Associative-embedding pull / push (margin 1) of each image's gt
    corner embeddings: tl_emb, br_emb (B, G) gathered at the gt corners,
    valid_mask (B, G). Returns (pull (B,), push (B,)), each weighted; push
    is 0 where an image has at most one valid gt."""
    m = valid_mask.to(tl_emb.dtype)
    n = m.sum(-1)
    mean = (tl_emb + br_emb) / 2.0
    pull = ((tl_emb - mean) ** 2 + (br_emb - mean) ** 2) * m
    pull = pull.sum(-1) / n.clamp(min=1.0)
    diff = (mean[:, :, None] - mean[:, None, :]).abs()
    eye = torch.eye(mean.shape[1], dtype=tl_emb.dtype, device=tl_emb.device)
    pair = m[:, :, None] * m[:, None, :] * (1.0 - eye)
    push = (torch.relu(1.0 - diff) * pair).sum((1, 2)) / \
        (n * (n - 1.0)).clamp(min=1.0)
    push = torch.where(n > 1, push, torch.zeros_like(push))
    return pull_weight * pull, push_weight * push
