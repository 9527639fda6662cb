from .detectors import (CrowdDetDetector, CrowdDetNet,
                        DeformableDETRDetector, DETRNet, DINODetector,
                        ERDConfig, ERDDetector, FasterRCNNDetector,
                        FasterRCNNNet, GFLDetector, GFLNet, VFNetDetector,
                        VFNetNet)
from .heads import GFLTestConfig, GFLTrainConfig

__all__ = ['CrowdDetDetector', 'CrowdDetNet', 'DeformableDETRDetector',
           'DETRNet', 'DINODetector', 'ERDConfig',
           'ERDDetector', 'FasterRCNNDetector', 'FasterRCNNNet',
           'GFLDetector', 'GFLNet', 'GFLTestConfig', 'GFLTrainConfig',
           'VFNetDetector', 'VFNetNet']
