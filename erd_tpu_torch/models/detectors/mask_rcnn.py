"""Mask R-CNN (R50-FPN) serving; the counterpart of
erd_tpu/models/detectors/mask_rcnn.py.

Faster R-CNN's detections, then the mask branch on them: the boxes scaled
back into the canvas (``scale_boxes``), RoIAlign 14x14 of P2-P5 (the kernel
``csrc/roi_align.cu`` at ``out_size=14``, float32 samples of the maps),
``FCNMaskHead`` in float32 on weights rounded to the compute dtype, the
detected class's channel and a sigmoid: ``predict`` returns (DetResults,
masks (B, 100, 28, 28) probabilities), as erd_tpu's does. Pasting the masks
into the image happens on the host, outside the detector. The mask loss
comes with training (``loss`` raises).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops import multilevel_roi_align
from ...ops.sampling import TRAIN_ITEM
from ...structures import DetResults, scale_boxes
from ..heads.mask_head import FCNMaskHead
from .faster_rcnn import ROI_STRIDES, FasterRCNNDetector, FasterRCNNNet


class MaskRCNNNet(FasterRCNNNet):
    """Faster R-CNN's network with ``roi_head.mask_head``."""

    def __init__(self, num_classes: int, depth: int = 50,
                 frozen_stages: int = -1,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, depth=depth,
                         frozen_stages=frozen_stages,
                         param_dtype=param_dtype)
        self.roi_head.mask_head = FCNMaskHead(num_classes,
                                              param_dtype=param_dtype)

    def init_head(self, normal):
        super().init_head(normal)
        up = self.roi_head.mask_head.upsample.weight
        # flax's lecun-normal over the (2, 2, I) fan-in of the kernel
        normal(up, (4 * up.shape[0]) ** -0.5)


def pick_class(logits, labels):
    """(R, C, H, W) logits, (R,) labels -> (R, H, W) of each RoI's class
    (labels clipped into range, as erd_tpu's)."""
    r, c = logits.shape[:2]
    idx = labels.reshape(-1).long().clamp(0, c - 1)
    return logits[torch.arange(r, device=logits.device), idx]


@dataclass
class MaskRCNNDetector(FasterRCNNDetector):
    """Config + functions of Mask R-CNN (serving)."""
    mask_size: int = 28

    def build_net(self) -> MaskRCNNNet:
        return MaskRCNNNet(self.num_classes, depth=self.depth,
                           frozen_stages=self.frozen_stages,
                           param_dtype=self.compute_dtype)

    @staticmethod
    def mask_rois(res: DetResults, meta, rescale=True):
        """The detections in the canvas frame, where the mask branch
        samples (B, D, 4)."""
        return scale_boxes(res.bboxes, meta.scale_factor) if rescale \
            else res.bboxes

    @staticmethod
    def mask_feats(feats, rois):
        """(B, D, 256, 14, 14) float32 RoIAlign of P2-P5."""
        return multilevel_roi_align(feats[:len(ROI_STRIDES)], rois,
                                    ROI_STRIDES, out_size=14)

    @torch.no_grad()
    def mask_predict(self, net: MaskRCNNNet, feats, res: DetResults, meta,
                     rescale=True):
        """(B, D, 28, 28) mask probabilities of the detections."""
        rois = self.mask_rois(res, meta, rescale)
        b, d = rois.shape[:2]
        roi14 = self.mask_feats(feats, rois)
        logits = net.roi_head.mask_head(roi14.flatten(0, 1)).float()
        return torch.sigmoid(pick_class(logits, res.labels)).reshape(
            b, d, self.mask_size, self.mask_size)

    @torch.no_grad()
    def predict_from_feats(self, net: MaskRCNNNet, canvas_shape, feats,
                           rpn_cls, rpn_reg, meta, rescale=True):
        """(DetResults, masks) after the network's first stage."""
        res = super().predict_from_feats(net, canvas_shape, feats, rpn_cls,
                                         rpn_reg, meta, rescale=rescale)
        return res, self.mask_predict(net, feats, res, meta, rescale)

    def loss(self, net, batch, draws=None):
        raise NotImplementedError(f'the mask loss is not ported yet '
                                  f'({TRAIN_ITEM})')
