"""Host-side test pipeline: keep-ratio resize, bucket-pad, pack; the
counterpart of erd_tpu/data/transforms.py in test mode.

Every image lands in one of two static canvases, (800, 1344) landscape or
(1344, 800) portrait at the default scale, as in erd_tpu. The resize is
PyTorch's bilinear interpolation (``align_corners=False``, no antialias),
which matches OpenCV's INTER_LINEAR to within one grey level, so the port
needs neither cv2 nor PIL.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..structures.det_sample import GTInstances, ImageMeta
from .coco import ImageRecord


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB from an image file (needs cv2 or PIL)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError('reading an image file needs cv2 or PIL; neither '
                          'is installed (pass RGB numpy arrays instead)'
                          ) from e
    return np.asarray(Image.open(path).convert('RGB'))


def rescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmcv-style keep-ratio size: long edge <= scale[0], short <= scale[1]."""
    long_edge, short_edge = max(scale), min(scale)
    f = min(long_edge / max(h, w), short_edge / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def resize_image(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W, C) uint8 image, rounded to uint8."""
    h, w = size_hw
    if img.shape[:2] == (h, w):
        return img
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t.float(), size=(h, w), mode='bilinear',
                        align_corners=False, antialias=False)
    out = out[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    return out.numpy()


def bucket_shape(h: int, w: int, scale=(1333, 800), divisor=32):
    """Static canvas for an image's orientation."""
    long_edge = int(np.ceil(max(scale) / divisor) * divisor)
    short_edge = int(np.ceil(min(scale) / divisor) * divisor)
    return (short_edge, long_edge) if w >= h else (long_edge, short_edge)


@dataclass
class DetPipeline:
    """record -> (canvas uint8, GTInstances, ImageMeta), test mode only."""
    scale: Tuple[int, int] = (1333, 800)
    max_gt: int = 100
    divisor: int = 32

    def __call__(self, record: ImageRecord,
                 image: Optional[np.ndarray] = None):
        img = image if image is not None else imread_rgb(record.path)
        ori_h, ori_w = img.shape[:2]
        new_h, new_w = rescale_size(ori_h, ori_w, self.scale)
        img = resize_image(img, (new_h, new_w))
        sx, sy = new_w / ori_w, new_h / ori_h
        boxes = record.bboxes * np.array([sx, sy, sx, sy], np.float32)
        ch, cw = bucket_shape(ori_h, ori_w, self.scale, self.divisor)
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:new_h, :new_w] = img
        gt = GTInstances.pad(boxes, record.labels, self.max_gt,
                             ignore=record.ignore)
        meta = ImageMeta.make((new_h, new_w), (ori_h, ori_w), (sx, sy),
                              img_id=record.img_id)
        return canvas, gt, meta
