from .anchors import AnchorGenerator, featmap_sizes_for, valid_flags
from .atss import AssignResult, atss_assign, atss_assign_plain
from .coder import DeltaXYWHBBoxCoder
from .hungarian import hungarian_match
from .max_iou import max_iou_assign
from .samplers import SampleResult, random_sample

__all__ = ['AnchorGenerator', 'featmap_sizes_for', 'valid_flags',
           'AssignResult', 'atss_assign', 'atss_assign_plain',
           'DeltaXYWHBBoxCoder', 'hungarian_match', 'max_iou_assign', 'SampleResult',
           'random_sample']
