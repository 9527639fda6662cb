from .build import build_detector, build_trainer
from .inference import inference_detector, init_detector

__all__ = ['build_detector', 'build_trainer', 'inference_detector',
           'init_detector']
