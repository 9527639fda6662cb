from .detectors import (ERDConfig, ERDDetector, FasterRCNNDetector,
                        FasterRCNNNet, GFLDetector, GFLNet)
from .heads import GFLTestConfig, GFLTrainConfig

__all__ = ['ERDConfig', 'ERDDetector', 'FasterRCNNDetector', 'FasterRCNNNet',
           'GFLDetector', 'GFLNet', 'GFLTestConfig', 'GFLTrainConfig']
