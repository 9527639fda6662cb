from .gfl_erd import ERDConfig, ERDDetector
from .single_stage import GFLDetector, GFLNet

__all__ = ['ERDConfig', 'ERDDetector', 'GFLDetector', 'GFLNet']
