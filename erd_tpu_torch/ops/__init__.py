from .carafe import (CARAFEPack, arrange_carafe, carafe, carafe_backward,
                     carafe_backward_plain, carafe_plain, carafe_weights)
from .deform_conv import (DeformConv2d, ModulatedDeformConv,
                          arrange_offsets, deform_conv2d, deform_im2col,
                          deform_im2col_backward,
                          deform_im2col_backward_plain, deform_im2col_plain)
from .integral import integral, integral_decode, integral_decode_plain
from .misc import (cap_candidates, filter_scores_and_topk, masked_mean_std,
                   topk_mask_select)
from .nms import (batched_nms_mask, nms_mask, nms_select, nms_select_cfg,
                  nms_sorted_keep, nms_sorted_keep_plain, set_nms_mask,
                  set_nms_sorted_keep, set_nms_sorted_keep_plain, soft_nms,
                  soft_nms_plain, soft_nms_select)
from .ms_deform_attn import (make_level_start_index, ms_deform_attn,
                             ms_deform_attn_backward,
                             ms_deform_attn_backward_plain,
                             ms_deform_attn_plain)
from .roi_align import (map_roi_levels, multilevel_roi_align, roi_align,
                        roi_align_backward, roi_align_backward_plain,
                        roi_align_level, roi_align_plain)

__all__ = ['CARAFEPack', 'arrange_carafe', 'carafe', 'carafe_backward',
           'carafe_backward_plain', 'carafe_plain', 'carafe_weights',
           'DeformConv2d', 'ModulatedDeformConv',
           'arrange_offsets', 'deform_conv2d', 'deform_im2col',
           'deform_im2col_backward', 'deform_im2col_backward_plain',
           'deform_im2col_plain', 'integral', 'integral_decode',
           'integral_decode_plain', 'cap_candidates', 'filter_scores_and_topk',
           'masked_mean_std', 'topk_mask_select', 'batched_nms_mask',
           'nms_mask', 'nms_select', 'nms_select_cfg', 'nms_sorted_keep',
           'nms_sorted_keep_plain', 'set_nms_mask', 'set_nms_sorted_keep',
           'set_nms_sorted_keep_plain', 'soft_nms', 'soft_nms_plain',
           'soft_nms_select', 'make_level_start_index', 'ms_deform_attn',
           'ms_deform_attn_backward', 'ms_deform_attn_backward_plain',
           'ms_deform_attn_plain', 'map_roi_levels', 'multilevel_roi_align',
           'roi_align', 'roi_align_backward', 'roi_align_backward_plain',
           'roi_align_level', 'roi_align_plain']
