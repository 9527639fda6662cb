from .coco import ImageRecord
from .transforms import (DetPipeline, bucket_shape, imread_rgb, rescale_size,
                         resize_image)

__all__ = ['ImageRecord', 'DetPipeline', 'bucket_shape', 'imread_rgb',
           'rescale_size', 'resize_image']
