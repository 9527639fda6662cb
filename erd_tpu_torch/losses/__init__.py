from .gfocal import distribution_focal_loss, quality_focal_loss
from .iou_loss import giou_loss
from .kd_loss import knowledge_distillation_kl_div_loss, l2_response_loss
from .utils import (binary_cross_entropy_with_logits, cross_entropy_int,
                    weight_reduce_loss)

__all__ = ['distribution_focal_loss', 'quality_focal_loss', 'giou_loss',
           'knowledge_distillation_kl_div_loss', 'l2_response_loss',
           'binary_cross_entropy_with_logits', 'cross_entropy_int',
           'weight_reduce_loss']
