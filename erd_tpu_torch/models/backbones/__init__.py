from .hourglass import HourglassNet
from .resnet import ResNet

__all__ = ['HourglassNet', 'ResNet']
