"""Config dicts -> detectors and trainers; the counterpart of
erd_tpu/apis/build.py for the ``GFL``, ``GFLIncrementERD``, ``VFNet``,
``FasterRCNN`` (with the FPN or the FPN_CARAFE neck), ``CrowdDet``,
``DeformableDETR``, ``DINO``, ``MaskRCNN``, ``PointRend`` and ``CornerNet``
model types, serving and training each (SGD, or Adam for CornerNet's
recipe)."""
from __future__ import annotations

import torch

from ..config import Config
from ..engine import Trainer, TrainerConfig
from ..models import (CornerNetDetector, CrowdDetDetector,
                      DeformableDETRDetector, DINODetector, ERDConfig,
                      ERDDetector, FasterRCNNDetector, GFLDetector,
                      GFLTestConfig, GFLTrainConfig, MaskRCNNDetector,
                      PointRendDetector, VFNetDetector)

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
_PORTED = ('GFL', 'GFLIncrementERD', 'VFNet', 'FasterRCNN', 'CrowdDet',
           'DeformableDETR', 'DINO', 'MaskRCNN', 'PointRend', 'CornerNet')
# the optimizers the port trains with: erd_tpu's SGD, and its Adam (AdamW
# with a zero decay)
_OPTIMIZERS = ('sgd', 'adam')
# erd_tpu model options whose code paths the port does not have yet (GN and
# WS heads, Shared4Conv1FC, Mask R-CNN's seesaw loss, backbone swaps, ...)
_NOT_PORTED = ('backbone', 'context_block_stages', 'gen_attention_stages',
               'head_norm', 'conv_ws', 'bbox_head', 'loss_cls')
ZOO_ITEM = 'ROADMAP.md, section 1: "Zoo, after the main path"'
# the model types whose port takes the backbone's DCN stages
_DCN = ('GFL', 'GFLIncrementERD', 'VFNet')


def _neck_spec(mtype: str, spec):
    """The one neck swap the port has: FPN_CARAFE on FasterRCNN, as a dict
    or a one-element chain; None without a neck. Anything else raises."""
    if not spec:
        return None
    chain = list(spec) if isinstance(spec, (list, tuple)) else [spec]
    if mtype != 'FasterRCNN' or len(chain) != 1 or \
            chain[0].get('type') != 'FPN_CARAFE':
        raise NotImplementedError(
            f'model.neck {spec} of {mtype} is not ported yet: the port has '
            f'FPN_CARAFE on FasterRCNN only ({ZOO_ITEM})')
    return dict(chain[0])


def build_detector(model_cfg: Config, num_devices: int = 1):
    mtype = model_cfg.get('type', 'GFL')
    if mtype not in _PORTED:
        raise NotImplementedError(
            f'detector type {mtype!r} is not ported yet ({ZOO_ITEM})')
    for key in _NOT_PORTED:
        if model_cfg.get(key):
            raise NotImplementedError(
                f'model.{key} of {mtype} is not ported yet ({ZOO_ITEM})')
    neck = _neck_spec(mtype, model_cfg.get('neck'))
    dcn = {}
    if model_cfg.get('dcn_stages'):
        if mtype not in _DCN:
            raise NotImplementedError(
                f'model.dcn_stages of {mtype} is not ported yet (ROADMAP.md, '
                f'section 1)')
        # DCNv2 (modulated) unless the config asks for DCNv1
        dcn = dict(dcn_stages=tuple(bool(s) for s in model_cfg.dcn_stages),
                   dcn_modulated=bool(model_cfg.get('dcn_modulated', True)))
    test = model_cfg.get('test_cfg', {})
    if mtype == 'CornerNet':
        # float32 whatever compute_dtype says: erd_tpu's CornerNet network
        # never reads it (models/detectors/cornernet.py)
        return CornerNetDetector(
            num_classes=model_cfg.get('num_classes', 80),
            corner_topk=test.get('corner_topk', 100),
            distance_threshold=test.get('distance_threshold', 0.5),
            score_thr=test.get('score_thr', 0.05),
            max_per_img=test.get('max_per_img', 100),
            nms_iou=test.get('nms_iou_threshold', 0.5),
            nms_type=test.get('nms_type', 'soft_nms'),
            soft_nms_sigma=test.get('soft_nms_sigma', 0.5),
            frozen_stages=model_cfg.get('frozen_stages', 1))
    if mtype in ('DeformableDETR', 'DINO'):  # erd_tpu's train configs
        cls = DINODetector if mtype == 'DINO' else DeformableDETRDetector
        return cls(
            num_classes=model_cfg.get('num_classes', 80),
            depth=model_cfg.get('depth', 50),
            compute_dtype=_DTYPES[model_cfg.get('compute_dtype', 'float32')],
            num_queries=model_cfg.get('num_queries', cls.num_queries),
            max_per_img=test.get('max_per_img', cls.max_per_img),
            frozen_stages=model_cfg.get('frozen_stages', 1))
    test_cfg = GFLTestConfig(
        score_thr=test.get('score_thr', 0.05),
        nms_pre=test.get('nms_pre', 1000),
        iou_threshold=test.get('nms_iou_threshold',
                               0.6 if mtype in ('GFL', 'GFLIncrementERD')
                               else 0.5),
        max_per_img=test.get('max_per_img', 100),
        min_bbox_size=test.get('min_bbox_size', 0.0),
        pre_nms_total=test.get('pre_nms_total', 2000),
        nms_type=test.get('nms_type', 'nms'),
        soft_nms_method=test.get('soft_nms_method', 'linear'),
        soft_nms_sigma=test.get('soft_nms_sigma', 0.5),
        soft_nms_min_score=test.get('soft_nms_min_score', 1e-3))
    train = model_cfg.get('train_cfg', {})
    base = dict(
        num_classes=model_cfg.get('num_classes', 80),
        depth=model_cfg.get('depth', 50),
        compute_dtype=_DTYPES[model_cfg.get('compute_dtype', 'float32')],
        frozen_stages=model_cfg.get('frozen_stages', 1),
        test_cfg=test_cfg)
    if mtype in ('FasterRCNN', 'CrowdDet'):
        sampler = train.get('rcnn_sampler', 'random')
        if sampler != 'random':
            raise NotImplementedError(
                f'model.train_cfg.rcnn_sampler={sampler!r} is not ported '
                f'yet: the port samples RoIs at random ({ZOO_ITEM})')
    if mtype == 'FasterRCNN':  # erd_tpu's train configs: the defaults
        return FasterRCNNDetector(neck=neck, **base)
    if mtype == 'CrowdDet':
        return CrowdDetDetector(**base)
    if mtype == 'MaskRCNN':
        return MaskRCNNDetector(**base)
    if mtype == 'PointRend':
        return PointRendDetector(**base)
    if mtype == 'VFNet':
        return VFNetDetector(**base, **dcn)
    common = dict(
        reg_max=model_cfg.get('reg_max', 16),
        train_cfg=GFLTrainConfig(
            assigner_topk=train.get('assigner_topk', 9)),
        **base, **dcn)
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


def _normalized_optim(cfg: Config) -> dict:
    """The repo-native ``optim`` section with the reference-style
    ``optim_wrapper`` overlay (optimizer type, lr, momentum, weight decay,
    clip_grad) merged into one flat dict."""
    optim = dict(cfg.get('optim', {}))
    inner = cfg.get('optim_wrapper', {}).get('optimizer', {})
    for k in ('type', 'lr', 'momentum', 'weight_decay'):
        if k in inner:
            optim[k] = inner[k]
    clip = cfg.get('optim_wrapper', {}).get('clip_grad')
    if clip:
        optim['grad_clip'] = clip.get('max_norm')
    return optim


def build_trainer(cfg: Config, detector, train_loader, teacher=None,
                  device=None) -> Trainer:
    """A Trainer for ``detector`` from the config's ``optim``,
    ``train_cfg`` and ``auto_scale_lr``; the networks' ``frozen_stages``
    come from the detector.

    ``teacher`` is the frozen ERD teacher network; the other detectors
    take none. The device is ``cuda`` unless the caller names one. The port
    has SGD, and Adam without weight decay (CornerNet's ``type='Adam'``, or
    ``AdamW`` with a zero decay), each with warmup + multi-step decay over
    steps; AdamW with a decay, other schedules, epoch-based warmup,
    gradient clipping, a backbone learning-rate multiplier, validation,
    checkpoints and custom hooks are not ported yet and raise. The DETR
    configs name no optimizer, so they train with SGD as erd_tpu's trainer
    does.
    """
    if teacher is not None and not isinstance(detector, ERDDetector):
        raise ValueError(f'a teacher is ERD distillation\'s: '
                         f'{type(detector).__name__} trains without one')
    optim = _normalized_optim(cfg)
    opt = optim.get('type', 'SGD').lower()
    if opt == 'adamw' and optim.get('weight_decay', 1e-4) == 0:
        opt = 'adam'  # erd_tpu's AdamW with a zero decay is its Adam
    if opt not in _OPTIMIZERS or \
            optim.get('schedule', 'multistep') != 'multistep':
        raise NotImplementedError(
            f'optimizer {optim.get("type")!r} with schedule '
            f'{optim.get("schedule", "multistep")!r} is not ported yet: the '
            f'port has SGD and Adam with warmup + multi-step decay '
            f'({ZOO_ITEM})')
    for key, default in (('grad_clip', None), ('backbone_lr_mult', 1.0),
                         ('warmup_epochs', 0)):
        if optim.get(key, default) != default:
            raise NotImplementedError(f'optim.{key} is not ported yet '
                                      f'({ZOO_ITEM})')
    if cfg.get('custom_hooks'):
        raise NotImplementedError('custom_hooks are not ported yet')
    train_cfg = cfg.get('train_cfg', {})
    scale = cfg.get('auto_scale_lr', {})
    base_batch = scale.get('base_batch_size', 16) if \
        scale.get('enable', True) else train_loader.cfg.batch_size
    tc = TrainerConfig(
        epochs=train_cfg.get('epochs', 12),
        base_lr=optim.get('lr', 0.01),
        momentum=optim.get('momentum', 0.9),
        weight_decay=optim.get('weight_decay', 1e-4),
        warmup_iters=optim.get('warmup_iters', 500),
        warmup_factor=optim.get('warmup_factor', 0.001),
        milestones_epochs=tuple(optim.get('milestones_epochs', (8, 11))),
        gamma=optim.get('gamma', 0.1),
        auto_scale_base_batch=base_batch,
        log_interval=cfg.get('log_interval', 50),
        optimizer='Adam' if opt == 'adam' else 'SGD')
    return Trainer(detector, train_loader, tc, teacher=teacher, device=device)
