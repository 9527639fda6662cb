from .detectors import ERDConfig, ERDDetector, GFLDetector, GFLNet
from .heads import GFLTestConfig

__all__ = ['ERDConfig', 'ERDDetector', 'GFLDetector', 'GFLNet',
           'GFLTestConfig']
