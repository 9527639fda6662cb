"""User-facing inference API; the counterpart of erd_tpu/apis/inference.py.

``init_detector`` builds the detector from a config and its network on a
device (``cuda`` unless the caller names one); ``inference_detector`` runs
the host test pipeline and the device predict path per image. Both work for
any detector with ``init(seed, device)`` and ``predict(net, batch)``: the
GFL / ERD detectors, Faster R-CNN, Mask R-CNN, PointRend, CornerNet,
Deformable DETR and DINO. Where ``predict`` returns (DetResults, masks), as
Mask R-CNN's and PointRend's do, ``inference_detector`` returns the boxes;
the masks come from ``predict``, as in erd_tpu's evaluation loop (erd_tpu's
own ``inference_detector`` fails on the tuple).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config
from ..data.coco import ImageRecord
from ..data.transforms import DetPipeline, imread_rgb
from ..evaluation.coco_eval import DetectionResult
from ..models.weight_import import load_torch_checkpoint_file
from ..structures import stack_to
from ..utils import resolve_device
from .build import build_detector


def init_detector(config: Union[str, Config],
                  checkpoint: Optional[str] = None, seed: int = 0,
                  device=None):
    """Returns (detector, net, cfg); ``net`` holds the weights.

    Weights are random from ``seed`` unless ``checkpoint`` names an mmdet
    ``.pth`` of the config's model (GFL and Faster R-CNN; the DETR family
    raises). ``device`` defaults to ``cuda`` and raises without it.
    """
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    det = build_detector(cfg.model)
    # built and loaded on the CPU, then moved to the device once
    net = det.init(seed=seed, device='cpu')
    if checkpoint:
        load_torch_checkpoint_file(net, checkpoint)
    return det, net.to(device), cfg


def inference_detector(detector, net,
                       imgs: Union[str, np.ndarray,
                                   Sequence[Union[str, np.ndarray]]],
                       scale=(1333, 800)) -> List[DetectionResult]:
    """Run detection on one or more images (paths or RGB arrays)."""
    single = isinstance(imgs, (str, np.ndarray))
    if single:
        imgs = [imgs]
    device = next(net.parameters()).device
    pipe = DetPipeline(scale=scale)
    results = []
    for i, item in enumerate(imgs):
        img = imread_rgb(item) if isinstance(item, str) else item
        rec = ImageRecord(img_id=i, path='', width=img.shape[1],
                          height=img.shape[0],
                          bboxes=np.zeros((0, 4), np.float32),
                          labels=np.zeros((0,), np.int32),
                          ignore=np.zeros((0,), bool))
        canvas, _, meta = pipe(rec, image=img)
        batch = dict(images=torch.from_numpy(canvas[None]).to(device),
                     meta=stack_to([meta], device))
        res = detector.predict(net, batch)
        if isinstance(res, tuple):  # (DetResults, masks) of the mask models
            res = res[0]
        m = res.mask[0].cpu().numpy()
        results.append(DetectionResult(
            img_id=i, bboxes=res.bboxes[0].cpu().numpy()[m],
            scores=res.scores[0].cpu().numpy()[m],
            labels=res.labels[0].cpu().numpy().astype(np.int32)[m]))
    return results[0] if single else results
