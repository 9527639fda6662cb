"""``local_maximum``, the one function of erd_tpu/ops/gaussian.py that
serving runs (CornerNet's heatmap decode); the target renderers come with
training."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def local_maximum(heat, kernel: int = 3):
    """Keep the values of (B, C, H, W) ``heat`` that equal the max of their
    kernel x kernel window (padded with -inf), 0 elsewhere."""
    hmax = F.max_pool2d(heat, kernel, stride=1, padding=(kernel - 1) // 2)
    return torch.where(hmax == heat, heat, torch.zeros((), dtype=heat.dtype,
                                                       device=heat.device))
