from .detectors import (CornerNetDetector, CornerNetNet,
                        CrowdDetDetector, CrowdDetNet,
                        DeformableDETRDetector, DETRNet, DINODetector,
                        ERDConfig, ERDDetector, FasterRCNNDetector,
                        FasterRCNNNet, GFLDetector, GFLNet,
                        MaskRCNNDetector, MaskRCNNNet, PointRendDetector,
                        PointRendNet, SOLOV2Detector, SOLOV2Net,
                        VFNetDetector, VFNetNet)
from .heads import GFLTestConfig, GFLTrainConfig

__all__ = ['CornerNetDetector', 'CornerNetNet', 'CrowdDetDetector',
           'CrowdDetNet', 'DeformableDETRDetector',
           'DETRNet', 'DINODetector', 'ERDConfig',
           'ERDDetector', 'FasterRCNNDetector', 'FasterRCNNNet',
           'GFLDetector', 'GFLNet', 'GFLTestConfig', 'GFLTrainConfig',
           'MaskRCNNDetector', 'MaskRCNNNet', 'PointRendDetector',
           'PointRendNet', 'SOLOV2Detector', 'SOLOV2Net', 'VFNetDetector',
           'VFNetNet']
