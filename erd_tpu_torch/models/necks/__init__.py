from .fpn import FPN

__all__ = ['FPN']
