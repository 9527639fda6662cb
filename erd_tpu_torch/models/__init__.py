from .detectors import (DeformableDETRDetector, DETRNet, DINODetector,
                        ERDConfig, ERDDetector, FasterRCNNDetector,
                        FasterRCNNNet, GFLDetector, GFLNet, VFNetDetector,
                        VFNetNet)
from .heads import GFLTestConfig, GFLTrainConfig

__all__ = ['DeformableDETRDetector', 'DETRNet', 'DINODetector', 'ERDConfig',
           'ERDDetector', 'FasterRCNNDetector', 'FasterRCNNNet',
           'GFLDetector', 'GFLNet', 'GFLTestConfig', 'GFLTrainConfig',
           'VFNetDetector', 'VFNetNet']
