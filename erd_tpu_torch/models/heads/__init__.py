from .bbox_head import Shared2FCBBoxHead, rcnn_predict
from .gfl_head import (AnchorContext, GFLHeadNet, GFLTargets, GFLTestConfig,
                       GFLTrainConfig, flatten_levels, gfl_loss, gfl_predict,
                       gfl_targets)
from .rpn_head import (ProposalConfig, RPNHeadNet, rpn_anchor_generator,
                       rpn_proposals)

__all__ = ['AnchorContext', 'GFLHeadNet', 'GFLTargets', 'GFLTestConfig',
           'GFLTrainConfig', 'flatten_levels', 'gfl_loss', 'gfl_predict',
           'gfl_targets', 'ProposalConfig', 'RPNHeadNet',
           'Shared2FCBBoxHead', 'rcnn_predict', 'rpn_anchor_generator',
           'rpn_proposals']
