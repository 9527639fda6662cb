"""Detection results; the counterpart of erd_tpu/evaluation/coco_eval.py
(``DetectionResult`` only: the COCO evaluator belongs to a later slice)."""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass
class DetectionResult:
    """Detections for one image, labels in dataset-contiguous space."""
    img_id: int
    bboxes: np.ndarray  # (n, 4) xyxy, original-image frame
    scores: np.ndarray
    labels: np.ndarray
