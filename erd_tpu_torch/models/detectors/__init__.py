from .cornernet import CornerNetDetector, CornerNetNet
from .crowddet import CrowdDetDetector, CrowdDetNet, MultiInstanceBBoxHead
from .deformable_detr import DeformableDETRDetector, DETRNet
from .dino import DINODetector
from .faster_rcnn import FasterRCNNDetector, FasterRCNNNet
from .gfl_erd import ERDConfig, ERDDetector
from .mask_rcnn import MaskRCNNDetector, MaskRCNNNet
from .point_rend import PointRendDetector, PointRendNet
from .single_stage import GFLDetector, GFLNet
from .solov2 import SOLOV2Detector, SOLOV2Net
from .vfnet import VFNetDetector, VFNetNet

__all__ = ['CornerNetDetector', 'CornerNetNet', 'CrowdDetDetector',
           'CrowdDetNet', 'MultiInstanceBBoxHead',
           'DeformableDETRDetector', 'DETRNet', 'DINODetector', 'ERDConfig',
           'ERDDetector', 'FasterRCNNDetector', 'FasterRCNNNet',
           'GFLDetector', 'GFLNet', 'MaskRCNNDetector', 'MaskRCNNNet',
           'PointRendDetector', 'PointRendNet', 'SOLOV2Detector', 'SOLOV2Net',
           'VFNetDetector', 'VFNetNet']
