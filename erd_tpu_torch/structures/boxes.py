"""Box math on tensors; the counterpart of erd_tpu/structures/boxes.py.

Every function broadcasts over leading batch dims and repeats the reference's
arithmetic op for op, so the port's boxes match erd_tpu's to float rounding.
"""
from __future__ import annotations

import torch


def _as_tensor_like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def distance2bbox(points, distance, max_shape=None):
    """Decode (left, top, right, bottom) distances into xyxy boxes.

    Args:
        points: (..., 2) anchor-centre xy.
        distance: (..., 4) distances to the four sides.
        max_shape: optional (H, W), or a (B, 2) tensor of per-image (H, W)
            for (B, K, 4) boxes, to clip into.
    """
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    bboxes = torch.stack([x1, y1, x2, y2], dim=-1)
    if max_shape is not None:
        shape = _as_tensor_like(max_shape, bboxes)
        h, w = shape[..., 0], shape[..., 1]
        wh = torch.stack([w, h, w, h], dim=-1)
        while wh.dim() < bboxes.dim():
            wh = wh.unsqueeze(-2)
        bboxes = torch.minimum(bboxes.clamp(min=0), wh)
    return bboxes


def bbox_area(boxes):
    """(..., 4) xyxy -> (...,) area; degenerate boxes give 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    return w * h


def bbox2distance(points, bbox, max_dis=None, eps=0.1):
    """Encode xyxy boxes as (l, t, r, b) distances from points, clamped to
    [0, max_dis - eps] when ``max_dis`` is given."""
    dist = torch.stack([points[..., 0] - bbox[..., 0],
                        points[..., 1] - bbox[..., 1],
                        bbox[..., 2] - points[..., 0],
                        bbox[..., 3] - points[..., 1]], dim=-1)
    if max_dis is not None:
        dist = dist.clamp(0, max_dis - eps)
    return dist


def bbox_overlaps(bboxes1, bboxes2, mode='iou', is_aligned=False, eps=1e-6):
    """Pairwise (..., m, n) or aligned (..., m) IoU, or GIoU with
    ``mode='giou'``."""
    if mode not in ('iou', 'giou'):
        raise ValueError(f'unknown mode {mode!r}')
    area1 = bbox_area(bboxes1)
    area2 = bbox_area(bboxes2)
    if not is_aligned:
        b1 = bboxes1[..., :, None, :]
        b2 = bboxes2[..., None, :, :]
        area1 = area1[..., :, None]
        area2 = area2[..., None, :]
    else:
        b1, b2 = bboxes1, bboxes2
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = (area1 + area2 - overlap).clamp(min=eps)
    ious = overlap / union
    if mode == 'iou':
        return ious
    enc_lt = torch.minimum(b1[..., :2], b2[..., :2])
    enc_rb = torch.maximum(b1[..., 2:], b2[..., 2:])
    enc_wh = (enc_rb - enc_lt).clamp(min=0)
    enc_area = (enc_wh[..., 0] * enc_wh[..., 1]).clamp(min=eps)
    return ious - (enc_area - union) / enc_area


def bbox_center(boxes):
    """(..., 4) xyxy -> (..., 2) centre xy."""
    return (boxes[..., :2] + boxes[..., 2:]) / 2.0


def scale_boxes(boxes, scale_factor):
    """Multiply boxes by per-axis (sx, sy) factors; (..., 2) broadcasts
    against the leading dims of (..., K, 4) boxes."""
    scale_factor = _as_tensor_like(scale_factor, boxes)
    sx, sy = scale_factor[..., 0], scale_factor[..., 1]
    s = torch.stack([sx, sy, sx, sy], dim=-1)
    while s.dim() < boxes.dim():
        s = s.unsqueeze(-2)
    return boxes * s
