from .anchors import AnchorGenerator, featmap_sizes_for, valid_flags
from .atss import AssignResult, atss_assign, atss_assign_plain
from .coder import DeltaXYWHBBoxCoder

__all__ = ['AnchorGenerator', 'featmap_sizes_for', 'valid_flags',
           'AssignResult', 'atss_assign', 'atss_assign_plain',
           'DeltaXYWHBBoxCoder']
