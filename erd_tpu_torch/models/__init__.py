from .detectors import (DeformableDETRDetector, DETRNet, DINODetector,
                        ERDConfig, ERDDetector, FasterRCNNDetector,
                        FasterRCNNNet, GFLDetector, GFLNet)
from .heads import GFLTestConfig, GFLTrainConfig

__all__ = ['DeformableDETRDetector', 'DETRNet', 'DINODetector', 'ERDConfig',
           'ERDDetector', 'FasterRCNNDetector', 'FasterRCNNNet',
           'GFLDetector', 'GFLNet', 'GFLTestConfig', 'GFLTrainConfig']
