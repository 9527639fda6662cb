from .integral import integral, integral_decode, integral_decode_plain
from .misc import cap_candidates, filter_scores_and_topk
from .nms import (batched_nms_mask, nms_mask, nms_select, nms_select_cfg,
                  nms_sorted_keep, nms_sorted_keep_plain, soft_nms_select)

__all__ = ['integral', 'integral_decode', 'integral_decode_plain',
           'cap_candidates', 'filter_scores_and_topk', 'batched_nms_mask',
           'nms_mask', 'nms_select', 'nms_select_cfg', 'nms_sorted_keep',
           'nms_sorted_keep_plain', 'soft_nms_select']
