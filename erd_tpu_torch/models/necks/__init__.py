from .channel_mapper import ChannelMapper
from .fpn import FPN
from .pyramid_extras import FPNCARAFE

__all__ = ['ChannelMapper', 'FPN', 'FPNCARAFE']
