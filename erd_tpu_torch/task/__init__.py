from .anchors import AnchorGenerator, featmap_sizes_for

__all__ = ['AnchorGenerator', 'featmap_sizes_for']
