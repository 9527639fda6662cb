"""ERD incremental detector; the counterpart of
erd_tpu/models/detectors/gfl_erd.py, serving part.

The stage-2 ERD student serves exactly as a GFL detector (its predict is
``GFLDetector.predict``). The frozen teacher, the ERS selection, the
distillation losses and ``widen_cls_head`` belong to the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .single_stage import GFLDetector


@dataclass
class ERDConfig:
    ori_num_classes: int = 40
    dist_loss_weight: float = 1.0
    ld_weight: float = 0.25
    ld_T: float = 10.0
    distill_nms_iou: float = 0.005
    ers_reg_cap: int = 0
    ers_nms_fast_k: int = 1024
    num_devices: int = 1


@dataclass
class ERDDetector(GFLDetector):
    """The ERD student detector; serves through ``GFLDetector.predict``."""
    erd: ERDConfig = field(default_factory=ERDConfig)

    def loss(self, *args, **kwargs):
        raise NotImplementedError(
            'ERDDetector.loss is not ported yet: it belongs to the training '
            'slice (ROADMAP.md, section 1, item 6 "ERD detector")')
