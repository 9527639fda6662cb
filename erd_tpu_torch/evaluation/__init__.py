from .coco_eval import DetectionResult

__all__ = ['DetectionResult']
