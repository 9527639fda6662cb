"""Anchor-delta box coder; the counterpart of erd_tpu/task/coder.py
``DeltaXYWHBBoxCoder`` (the Faster R-CNN family).

Every op repeats the reference's arithmetic in float32, including the
``wh_ratio_clip`` bound ``|log(16 / 1000)|`` taken in float32.
"""
from __future__ import annotations

import torch


class DeltaXYWHBBoxCoder:
    """Classic (dx, dy, dw, dh) anchor-delta coder."""

    def __init__(self, target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.), clip_border=True,
                 add_ctr_clamp=False):
        if add_ctr_clamp:  # YOLOF's centre clamp
            raise NotImplementedError(
                'DeltaXYWHBBoxCoder(add_ctr_clamp=True) is not ported yet')
        self.means = tuple(float(m) for m in target_means)
        self.stds = tuple(float(s) for s in target_stds)
        self.clip_border = clip_border

    def _stats(self, ref):
        return (torch.tensor(self.means, dtype=ref.dtype, device=ref.device),
                torch.tensor(self.stds, dtype=ref.dtype, device=ref.device))

    def encode(self, bboxes, gt_bboxes):
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = bboxes[..., 2] - bboxes[..., 0]
        ph = bboxes[..., 3] - bboxes[..., 1]
        gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        gw = gt_bboxes[..., 2] - gt_bboxes[..., 0]
        gh = gt_bboxes[..., 3] - gt_bboxes[..., 1]
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
        means, stds = self._stats(deltas)
        return (deltas - means) / stds

    def decode(self, bboxes, deltas, max_shape=None, wh_ratio_clip=16 / 1000):
        """Boxes (..., 4) and deltas (..., 4) broadcast together.

        ``max_shape``: (H, W), or a tensor whose last dim is (H, W) and whose
        leading dims broadcast against the boxes' leading dims, to clip to.
        """
        means, stds = self._stats(deltas)
        deltas = deltas * stds + means
        max_ratio = torch.log(torch.tensor(
            wh_ratio_clip, dtype=deltas.dtype, device=deltas.device)).abs()
        dx, dy = deltas[..., 0], deltas[..., 1]
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = bboxes[..., 2] - bboxes[..., 0]
        ph = bboxes[..., 3] - bboxes[..., 1]
        dw = torch.clamp(deltas[..., 2], -max_ratio, max_ratio)
        dh = torch.clamp(deltas[..., 3], -max_ratio, max_ratio)
        gx = px + pw * dx
        gy = py + ph * dy
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        boxes = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                             gx + gw * 0.5, gy + gh * 0.5], dim=-1)
        if max_shape is not None and self.clip_border:
            shape = torch.as_tensor(max_shape, dtype=boxes.dtype,
                                    device=boxes.device)
            h, w = shape[..., 0], shape[..., 1]
            wh = torch.stack([w, h, w, h], dim=-1)
            while wh.dim() < boxes.dim():
                wh = wh.unsqueeze(-2)
            boxes = torch.minimum(boxes.clamp(min=0), wh)
        return boxes
