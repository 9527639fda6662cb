from .extra import associative_embedding_loss, gaussian_focal_loss
from .focal import sigmoid_focal_loss
from .gfocal import distribution_focal_loss, quality_focal_loss
from .iou_loss import giou_loss
from .kd_loss import knowledge_distillation_kl_div_loss, l2_response_loss
from .smooth_l1 import l1_loss, smooth_l1_loss
from .utils import (binary_cross_entropy_with_logits, cross_entropy_int,
                    weight_reduce_loss)
from .varifocal import varifocal_loss

__all__ = ['associative_embedding_loss', 'gaussian_focal_loss',
           'distribution_focal_loss', 'quality_focal_loss', 'giou_loss',
           'knowledge_distillation_kl_div_loss', 'l2_response_loss',
           'l1_loss', 'smooth_l1_loss', 'binary_cross_entropy_with_logits',
           'cross_entropy_int', 'sigmoid_focal_loss', 'varifocal_loss',
           'weight_reduce_loss']
