"""Config dicts -> detectors; the counterpart of erd_tpu/apis/build.py for
the ``GFL`` and ``GFLIncrementERD`` model types."""
from __future__ import annotations

import torch

from ..config import Config
from ..models import ERDConfig, ERDDetector, GFLDetector, GFLTestConfig

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
# erd_tpu model options whose code paths the port does not have yet
_NOT_PORTED = ('backbone', 'neck', 'dcn_stages', 'context_block_stages',
               'gen_attention_stages')


def build_detector(model_cfg: Config, num_devices: int = 1):
    mtype = model_cfg.get('type', 'GFL')
    if mtype not in ('GFL', 'GFLIncrementERD'):
        raise NotImplementedError(
            f'detector type {mtype!r} is not ported yet (ROADMAP.md, '
            f'section 1, item 13)')
    for key in _NOT_PORTED:
        if model_cfg.get(key):
            raise NotImplementedError(f'model.{key} is not ported yet')
    test = model_cfg.get('test_cfg', {})
    test_cfg = GFLTestConfig(
        score_thr=test.get('score_thr', 0.05),
        nms_pre=test.get('nms_pre', 1000),
        iou_threshold=test.get('nms_iou_threshold', 0.6),
        max_per_img=test.get('max_per_img', 100),
        min_bbox_size=test.get('min_bbox_size', 0.0),
        pre_nms_total=test.get('pre_nms_total', 2000),
        nms_type=test.get('nms_type', 'nms'))
    common = dict(
        num_classes=model_cfg.get('num_classes', 80),
        depth=model_cfg.get('depth', 50),
        reg_max=model_cfg.get('reg_max', 16),
        compute_dtype=_DTYPES[model_cfg.get('compute_dtype', 'float32')],
        test_cfg=test_cfg)
    if mtype == 'GFL':
        return GFLDetector(**common)
    erd = model_cfg.get('erd', {})
    ori = model_cfg.get('ori_setting', {})
    if 'ers_cls_cap' in erd:
        raise ValueError(
            'erd.ers_cls_cap is not a knob: the cls-branch ERS selection is '
            'dense-exact. Remove it from the config.')
    return ERDDetector(
        erd=ERDConfig(
            ori_num_classes=ori.get('ori_num_classes', 40),
            dist_loss_weight=erd.get('dist_loss_weight', 1.0),
            ld_weight=erd.get('ld_weight', 0.25),
            ld_T=erd.get('ld_T', 10),
            distill_nms_iou=erd.get('distill_nms_iou', 0.005),
            ers_reg_cap=erd.get('ers_reg_cap', 0),
            num_devices=num_devices),
        **common)
