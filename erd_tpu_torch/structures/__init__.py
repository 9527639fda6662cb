from .boxes import (bbox2distance, bbox_area, bbox_center, bbox_overlaps,
                    cxcywh_to_xyxy, distance2bbox, scale_boxes,
                    xyxy_to_cxcywh)
from .det_sample import DetResults, GTInstances, ImageMeta, stack_to

__all__ = ['bbox2distance', 'bbox_area', 'bbox_center', 'bbox_overlaps',
           'cxcywh_to_xyxy', 'distance2bbox', 'scale_boxes', 'xyxy_to_cxcywh',
           'DetResults', 'GTInstances', 'ImageMeta', 'stack_to']
