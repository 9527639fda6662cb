"""On-device batch normalisation; the counterpart of
erd_tpu/models/preprocessor.py.

The host pipeline emits (B, H, W, 3) uint8 RGB canvases (1 byte per pixel
over the bus); normalisation runs on the device directly in the compute
dtype, and the result is NCHW for the network.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class Preprocessor:
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    compute_dtype: torch.dtype = torch.float32

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB -> (B, 3, H, W) normalised compute_dtype."""
        mean = torch.as_tensor(self.mean, dtype=self.compute_dtype,
                               device=images.device)
        inv_std = torch.as_tensor(1.0 / np.asarray(self.std),
                                  dtype=self.compute_dtype,
                                  device=images.device)
        x = (images.to(self.compute_dtype) - mean) * inv_std
        return x.permute(0, 3, 1, 2)
