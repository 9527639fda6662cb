from .faster_rcnn import FasterRCNNDetector, FasterRCNNNet
from .gfl_erd import ERDConfig, ERDDetector
from .single_stage import GFLDetector, GFLNet

__all__ = ['ERDConfig', 'ERDDetector', 'FasterRCNNDetector', 'FasterRCNNNet',
           'GFLDetector', 'GFLNet']
