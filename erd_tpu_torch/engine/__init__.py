from .hooks import CheckInvalidLossHook, Hook, LoggerHook
from .optim import resnet_frozen_paths, sgd_optimizer
from .schedules import auto_scale_lr, warmup_multistep
from .train_loop import Trainer, TrainerConfig, batch_to

__all__ = ['CheckInvalidLossHook', 'Hook', 'LoggerHook',
           'resnet_frozen_paths', 'sgd_optimizer', 'auto_scale_lr',
           'warmup_multistep', 'Trainer', 'TrainerConfig', 'batch_to']
