"""COCO records; the counterpart of erd_tpu/data/coco.py (``ImageRecord``
only: the dataset and loader belong to a later slice)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ImageRecord:
    img_id: int
    path: str
    width: int
    height: int
    bboxes: np.ndarray    # (n, 4) xyxy float32
    labels: np.ndarray    # (n,) int32 contiguous dataset labels
    ignore: np.ndarray    # (n,) bool (iscrowd or invalid)
