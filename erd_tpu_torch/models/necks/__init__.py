from .channel_mapper import ChannelMapper
from .fpn import FPN

__all__ = ['ChannelMapper', 'FPN']
