from .crowddet import CrowdDetDetector, CrowdDetNet, MultiInstanceBBoxHead
from .deformable_detr import DeformableDETRDetector, DETRNet
from .dino import DINODetector
from .faster_rcnn import FasterRCNNDetector, FasterRCNNNet
from .gfl_erd import ERDConfig, ERDDetector
from .single_stage import GFLDetector, GFLNet
from .vfnet import VFNetDetector, VFNetNet

__all__ = ['CrowdDetDetector', 'CrowdDetNet', 'MultiInstanceBBoxHead',
           'DeformableDETRDetector', 'DETRNet', 'DINODetector', 'ERDConfig',
           'ERDDetector', 'FasterRCNNDetector', 'FasterRCNNNet',
           'GFLDetector', 'GFLNet', 'VFNetDetector', 'VFNetNet']
