from .gfl_head import (AnchorContext, GFLHeadNet, GFLTargets, GFLTestConfig,
                       GFLTrainConfig, flatten_levels, gfl_loss, gfl_predict,
                       gfl_targets)

__all__ = ['AnchorContext', 'GFLHeadNet', 'GFLTargets', 'GFLTestConfig',
           'GFLTrainConfig', 'flatten_levels', 'gfl_loss', 'gfl_predict',
           'gfl_targets']
