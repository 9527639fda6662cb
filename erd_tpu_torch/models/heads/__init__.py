from .gfl_head import (AnchorContext, GFLHeadNet, GFLTestConfig,
                       flatten_levels, gfl_predict)

__all__ = ['AnchorContext', 'GFLHeadNet', 'GFLTestConfig', 'flatten_levels',
           'gfl_predict']
