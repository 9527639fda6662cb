from .bbox_head import Shared2FCBBoxHead, rcnn_predict
from .deformable_detr_head import (DeformableDETRHead, DeformableEncoderHead,
                                   MSDeformAttn, arrange_sampling)
from .dino_head import DINOHead
from .gfl_head import (AnchorContext, GFLHeadNet, GFLTargets, GFLTestConfig,
                       GFLTrainConfig, flatten_levels, gfl_loss, gfl_predict,
                       gfl_targets)
from .rpn_head import (ProposalConfig, RPNHeadNet, rpn_anchor_generator,
                       rpn_proposals)
from .vfnet_head import (VFNetContext, VFNetHeadNet, decode_levels,
                         star_offsets, vfnet_loss, vfnet_predict)

__all__ = ['AnchorContext', 'DINOHead', 'DeformableDETRHead',
           'DeformableEncoderHead', 'GFLHeadNet', 'GFLTargets',
           'GFLTestConfig', 'GFLTrainConfig', 'MSDeformAttn',
           'arrange_sampling', 'flatten_levels', 'gfl_loss', 'gfl_predict',
           'gfl_targets', 'ProposalConfig', 'RPNHeadNet',
           'Shared2FCBBoxHead', 'rcnn_predict', 'rpn_anchor_generator',
           'rpn_proposals', 'VFNetContext', 'VFNetHeadNet', 'decode_levels',
           'star_offsets', 'vfnet_loss', 'vfnet_predict']
