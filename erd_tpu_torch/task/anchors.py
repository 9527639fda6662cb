"""Anchor generation (host-side numpy, static per canvas shape).

The port's own copy of erd_tpu/task/anchors.py: ``len(ratios) *
scales_per_octave`` anchors of base size ``octave_base_scale * stride`` per
cell (one square anchor for GFL; ratios 0.5, 1, 2 for the RPN), centred at
``center_offset * stride`` and shifted onto the stride grid. Anchors are
cell-major (index ``(h * W + w) * A + a``), and within a cell ratio-major:
anchor ``a`` is ratio ``a // scales_per_octave``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class AnchorGenerator:
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (1.0,)
    octave_base_scale: int = 8
    scales_per_octave: int = 1
    center_offset: float = 0.0

    @property
    def num_base_anchors(self):
        return len(self.ratios) * self.scales_per_octave

    def base_anchors(self, stride):
        """(A, 4) base anchors for one stride."""
        octave_scales = np.array([2**(i / self.scales_per_octave)
                                  for i in range(self.scales_per_octave)])
        scales = octave_scales * self.octave_base_scale
        anchors = []
        cx = cy = self.center_offset * stride
        for ratio in self.ratios:
            h_ratio = math.sqrt(ratio)
            w_ratio = 1.0 / h_ratio
            for scale in scales:
                w = stride * scale * w_ratio
                h = stride * scale * h_ratio
                anchors.append([cx - 0.5 * w, cy - 0.5 * h,
                                cx + 0.5 * w, cy + 0.5 * h])
        return np.asarray(anchors, np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]):
        """Per-level (H*W*A, 4) anchors."""
        out = []
        for (h, w), stride in zip(featmap_sizes, self.strides):
            base = self.base_anchors(stride)
            sx = np.arange(w, dtype=np.float32) * stride
            sy = np.arange(h, dtype=np.float32) * stride
            gx, gy = np.meshgrid(sx, sy)
            shifts = np.stack([gx, gy, gx, gy], axis=-1).reshape(-1, 1, 4)
            out.append((shifts + base[None]).reshape(-1, 4).astype(
                np.float32))
        return out

    def flat_anchors(self, featmap_sizes):
        """All-level anchors concatenated: (sum_l H_l*W_l*A, 4)."""
        return np.concatenate(self.grid_anchors(featmap_sizes), axis=0)

    def num_level_anchors(self, featmap_sizes):
        return [h * w * self.num_base_anchors for h, w in featmap_sizes]


def featmap_sizes_for(image_shape: Tuple[int, int],
                      strides) -> List[Tuple[int, int]]:
    """Feature sizes of a stride-s conv stack: ceil(dim / stride)."""
    h, w = image_shape
    return [(int(math.ceil(h / s)), int(math.ceil(w / s))) for s in strides]


def valid_flags(featmap_sizes, strides, pad_shape):
    """Per-image anchor valid flags from (B, 2) float pad shapes (H, W),
    one anchor per cell: a cell is valid when its row < ceil(H / stride)
    and its column < ceil(W / stride) (the counterpart of erd_tpu's
    ``valid_flags_jax``). Returns (B, N) bool."""
    ph, pw = pad_shape[..., 0:1], pad_shape[..., 1:2]
    flags = []
    for (h, w), stride in zip(featmap_sizes, strides):
        vy = torch.arange(h, device=pad_shape.device) < torch.ceil(
            ph / stride)
        vx = torch.arange(w, device=pad_shape.device) < torch.ceil(
            pw / stride)
        flags.append((vy[..., :, None] & vx[..., None, :]).reshape(
            *pad_shape.shape[:-1], h * w))
    return torch.cat(flags, dim=-1)
