"""Detection sample containers; the counterpart of
erd_tpu/structures/det_sample.py as plain dataclasses (no flax).

Host-side constructors build numpy arrays; ``stack_to`` turns a list of
per-image records into one batched record of tensors on a device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch


def stack_to(items: Sequence[Any], device) -> Any:
    """Stack per-image dataclass records field-wise into tensors on
    ``device``; fields that are None stay None."""
    cls = type(items[0])
    out = {}
    for f in dataclasses.fields(cls):
        vals = [getattr(it, f.name) for it in items]
        out[f.name] = None if vals[0] is None else torch.as_tensor(
            np.stack([np.asarray(v) for v in vals]), device=device)
    return cls(**out)


@dataclass
class GTInstances:
    """Padded ground truth: bboxes (MAX_GT, 4), labels (MAX_GT,),
    mask (MAX_GT,) validity, and optional masks (MAX_GT, R, R) uint8
    instance-mask crops normalised to their gt boxes (R = 56, made by the
    data pipeline; Mask R-CNN and PointRend train on them)."""
    bboxes: Any
    labels: Any
    mask: Any
    masks: Any = None

    @staticmethod
    def pad(bboxes, labels, max_gt, ignore=None, masks=None):
        n = min(len(bboxes), max_gt)
        out_b = np.zeros((max_gt, 4), np.float32)
        out_l = np.zeros((max_gt,), np.int32)
        out_m = np.zeros((max_gt,), bool)
        out_b[:n] = np.asarray(bboxes, np.float32)[:n]
        out_l[:n] = np.asarray(labels, np.int32)[:n]
        out_m[:n] = True
        if ignore is not None:
            out_m[:n] &= ~np.asarray(ignore, bool)[:n]
        out_masks = None
        if masks is not None:
            r = masks[0].shape[0] if len(masks) else 56
            out_masks = np.zeros((max_gt, r, r), np.uint8)
            for i, mk in enumerate(masks[:max_gt]):
                out_masks[i] = mk
        return GTInstances(bboxes=out_b, labels=out_l, mask=out_m,
                           masks=out_masks)


@dataclass
class ImageMeta:
    """Per-image geometry: img_shape (H, W) of the resized image inside the
    canvas, ori_shape (H, W) on disk, scale_factor (sx, sy), flip, img_id,
    valid (False for batch-padding slots)."""
    img_shape: Any
    ori_shape: Any
    scale_factor: Any
    flip: Any
    img_id: Any
    valid: Any

    @staticmethod
    def make(img_shape, ori_shape, scale_factor, flip=False, img_id=-1,
             valid=True):
        return ImageMeta(
            img_shape=np.asarray(img_shape, np.float32),
            ori_shape=np.asarray(ori_shape, np.float32),
            scale_factor=np.asarray(scale_factor, np.float32),
            flip=np.asarray(flip, bool),
            img_id=np.asarray(img_id, np.int32),
            valid=np.asarray(valid, bool))


@dataclass
class DetResults:
    """Fixed-capacity detections: bboxes (..., MAX_DET, 4), scores, labels,
    mask (True for kept detections)."""
    bboxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor
    # candidates that entered NMS per image (valid after cap + size filter)
    num_candidates: Optional[torch.Tensor] = None
