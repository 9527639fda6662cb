from .integral import integral, integral_decode, integral_decode_plain
from .misc import (cap_candidates, filter_scores_and_topk, masked_mean_std,
                   topk_mask_select)
from .nms import (batched_nms_mask, nms_mask, nms_select, nms_select_cfg,
                  nms_sorted_keep, nms_sorted_keep_plain, soft_nms,
                  soft_nms_plain, soft_nms_select)
from .roi_align import (map_roi_levels, multilevel_roi_align, roi_align,
                        roi_align_level, roi_align_plain)

__all__ = ['integral', 'integral_decode', 'integral_decode_plain',
           'cap_candidates', 'filter_scores_and_topk', 'masked_mean_std',
           'topk_mask_select', 'batched_nms_mask',
           'nms_mask', 'nms_select', 'nms_select_cfg', 'nms_sorted_keep',
           'nms_sorted_keep_plain', 'soft_nms', 'soft_nms_plain',
           'soft_nms_select', 'map_roi_levels', 'multilevel_roi_align',
           'roi_align', 'roi_align_level', 'roi_align_plain']
