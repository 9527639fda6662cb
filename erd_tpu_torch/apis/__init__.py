from .build import build_detector
from .inference import inference_detector, init_detector

__all__ = ['build_detector', 'inference_detector', 'init_detector']
