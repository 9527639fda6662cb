"""DINO-4scale R50 serving; the counterpart of erd_tpu/models/detectors/
dino.py.

The backbone, neck and prediction of Deformable DETR
(``deformable_detr.py``) around ``DINOHead``: the deformable encoder,
mixed query selection and the box-refining decoder, with no denoising
queries at inference. Training (Hungarian matching, CDN queries and the
sampling kernel's backward) is not ported yet: ``loss`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..heads.dino_head import DINOHead
from .deformable_detr import DeformableDETRDetector, DETRNet, NOT_TRAINED_YET


@dataclass
class DINODetector(DeformableDETRDetector):
    """Config + functions of DINO serving; ``forward_raw`` returns erd_tpu's
    dict (all_cls, all_boxes, enc_cls, enc_boxes)."""
    num_queries: int = 900
    max_per_img: int = 300

    def build_net(self) -> DETRNet:
        return DETRNet(DINOHead(
            self.num_classes, num_queries=self.num_queries,
            param_dtype=self.compute_dtype), self.depth)

    def loss(self, net, batch):
        raise NotImplementedError(NOT_TRAINED_YET.format('DINO'))
