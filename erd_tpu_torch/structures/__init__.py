from .boxes import (bbox2distance, bbox_area, bbox_center, bbox_overlaps, distance2bbox,
                    scale_boxes)
from .det_sample import DetResults, GTInstances, ImageMeta, stack_to

__all__ = ['bbox2distance', 'bbox_area', 'bbox_center', 'bbox_overlaps', 'distance2bbox',
           'scale_boxes', 'DetResults', 'GTInstances', 'ImageMeta',
           'stack_to']
