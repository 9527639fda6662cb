"""Weight import into the port's GFL and Faster R-CNN networks; the
counterpart of erd_tpu/models/weight_import.py.

The port's modules carry the mmdet state-dict names, so an mmdet checkpoint
loads with a plain ``load_state_dict``, and the port's GFL ``state_dict``
reads back into erd_tpu with its ``load_mmdet_state_dict``.
``params_from_jax`` converts erd_tpu's variables (as nested numpy dicts)
into the port's ``state_dict``; ``widen_cls_head`` starts an ERD student
from its teacher's ``state_dict``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _backbone_module(mod: Tuple[str, ...]) -> str:
    if mod == ('stem_conv',):
        return 'backbone.conv1'
    if mod == ('stem_bn',):
        return 'backbone.bn1'
    m = re.fullmatch(r'layer(\d)_block(\d+)', mod[0])
    if m is None or len(mod) != 2:
        raise KeyError(f'unmapped backbone module {"/".join(mod)}')
    sub = {'downsample_conv': 'downsample.0',
           'downsample_bn': 'downsample.1'}.get(mod[1], mod[1])
    return f'backbone.layer{m.group(1)}.{m.group(2)}.{sub}'


def _neck_module(mod: Tuple[str, ...], n_fpn: int, start_level: int) -> str:
    name = mod[0]
    m = re.fullmatch(r'lateral_(\d+)', name)
    if m:  # erd_tpu numbers laterals by input level, from start_level
        return f'neck.lateral_convs.{int(m.group(1)) - start_level}.conv'
    m = re.fullmatch(r'fpn_conv_(\d+)', name)
    if m:
        return f'neck.fpn_convs.{m.group(1)}.conv'
    m = re.fullmatch(r'extra_conv_(\d+)', name)
    if m:
        return f'neck.fpn_convs.{n_fpn + int(m.group(1))}.conv'
    raise KeyError(f'unmapped neck module {"/".join(mod)}')


def _head_module(mod: Tuple[str, ...]) -> str:
    m = re.fullmatch(r'(cls|reg)_conv_(\d+)', mod[0])
    if m and len(mod) == 2:
        return f'bbox_head.{m.group(1)}_convs.{m.group(2)}.{mod[1]}'
    if mod[0] in ('gfl_cls', 'gfl_reg'):
        return f'bbox_head.{mod[0]}'
    m = re.fullmatch(r'scale_(\d+)', mod[0])
    if m:
        return f'bbox_head.scales.{m.group(1)}'
    raise KeyError(f'unmapped head module {"/".join(mod)}')


def _rcnn_module(scope: str, mod: Tuple[str, ...]) -> str:
    """Faster R-CNN's ``rpn_head`` and ``bbox_head`` scopes."""
    if scope == 'rpn_head' and mod[0] in ('rpn_conv', 'rpn_cls', 'rpn_reg'):
        return f'rpn_head.{mod[0]}'
    m = re.fullmatch(r'shared_fc(\d+)', mod[0])
    if scope == 'bbox_head' and m:
        return f'roi_head.bbox_head.shared_fcs.{m.group(1)}'
    if scope == 'bbox_head' and mod[0] in ('fc_cls', 'fc_reg'):
        return f'roi_head.bbox_head.{mod[0]}'
    raise KeyError(f'unmapped {scope} module {"/".join(mod)}')


def _shared_fc0_rows(kernel: np.ndarray, roi_size: int = 7) -> np.ndarray:
    """erd_tpu's first fc kernel (roi*roi*C, O), rows in (h, w, c) order,
    -> the (O, C*roi*roi) weight of mmdet's channel-major flatten."""
    rows, out = kernel.shape
    c = rows // (roi_size * roi_size)
    k = kernel.reshape(roi_size, roi_size, c, out)
    return np.transpose(k, (3, 2, 0, 1)).reshape(out, c * roi_size ** 2)


def _leaf(leaf: str, module: str, collection: str) -> str:
    if collection == 'batch_stats':
        return {'mean': 'running_mean', 'var': 'running_var'}[leaf]
    if leaf == 'kernel':
        return 'weight'
    if leaf == 'scale':  # norm gamma, or the per-level Scale parameter
        return 'scale' if '.scales.' in module else 'weight'
    return leaf


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """erd_tpu GFL or Faster R-CNN variables {'params', 'batch_stats'}
    (nested numpy dicts) -> the port's GFLNet or FasterRCNNNet
    ``state_dict``.

    Conv kernels go from (kh, kw, I, O) to (O, I, kh, kw), dense kernels
    from (I, O) to (O, I); the R-CNN head's first fc also reorders its
    input rows from erd_tpu's (7, 7, C) flatten to mmdet's (C, 7, 7). GN/BN
    ``scale`` becomes ``weight``; frozen-BN ``mean``/``var`` become
    ``running_mean``/``running_var``. The weights go one way: erd_tpu has
    no importer of Faster R-CNN state dicts.
    """
    params = variables['params']
    neck = params.get('neck', {})
    n_fpn = sum(1 for k in neck if k.startswith('fpn_conv_'))
    start_level = min((int(k[len('lateral_'):]) for k in neck
                       if k.startswith('lateral_')), default=0)
    two_stage = 'rpn_head' in params
    out = {}
    for collection in ('params', 'batch_stats'):
        for path, value in _flatten(variables.get(collection, {})):
            scope, mod, leaf = path[0], path[1:-1], path[-1]
            if scope == 'backbone':
                module = _backbone_module(mod)
            elif scope == 'neck':
                module = _neck_module(mod, n_fpn, start_level)
            elif two_stage and scope in ('rpn_head', 'bbox_head'):
                module = _rcnn_module(scope, mod)
            elif scope == 'bbox_head':
                module = _head_module(mod)
            else:
                raise KeyError(f'unmapped scope {"/".join(path)}')
            v = np.asarray(value, np.float32)
            if leaf == 'kernel' and v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            elif leaf == 'kernel' and module.endswith('shared_fcs.0'):
                v = _shared_fc0_rows(v)
            elif leaf == 'kernel' and v.ndim == 2:
                v = v.T
            key = f'{module}.{_leaf(leaf, module, collection)}'
            out[key] = torch.from_numpy(np.array(v, order='C'))
    return out


def load_torch_checkpoint_file(net: nn.Module, path: str):
    """Load an mmdet ``.pth`` into ``net`` (GFL or Faster R-CNN) in place.

    The file is unpickled (``weights_only=False``, as mmdet checkpoints
    carry metadata objects): load only trusted checkpoints. ``module.``
    prefixes and BN ``num_batches_tracked`` counters are dropped.
    Returns the result of ``load_state_dict``.
    """
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    state = ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt
    state = {(k[7:] if k.startswith('module.') else k): v
             for k, v in state.items()
             if not k.endswith('num_batches_tracked')}
    return net.load_state_dict(state, strict=True)


def widen_cls_head(teacher_state: Mapping[str, torch.Tensor],
                   student_state: Mapping[str, torch.Tensor],
                   ori_num_classes: int) -> Dict[str, torch.Tensor]:
    """Start the student as the teacher, with fresh rows for new classes.

    Every entry of the student's ``state_dict`` is copied from the
    teacher's, except ``bbox_head.gfl_cls.{weight,bias}``, whose output
    channels [ori_num_classes:) keep the student's values (the reference's
    _load_checkpoint_for_new_model, gfl_increment_erd.py:83-88).
    """
    out = {}
    for key, s in student_state.items():
        t = teacher_state[key]
        if key in ('bbox_head.gfl_cls.weight', 'bbox_head.gfl_cls.bias'):
            if t.shape[0] != ori_num_classes or \
                    t.shape[1:] != s.shape[1:]:
                raise ValueError(f'{key}: teacher {tuple(t.shape)} does not '
                                 f'widen to {tuple(s.shape)}')
            out[key] = torch.cat([t.to(s.device), s[ori_num_classes:]])
        else:
            if t.shape != s.shape:
                raise ValueError(f'{key}: teacher {tuple(t.shape)} vs '
                                 f'student {tuple(s.shape)}')
            out[key] = t.detach().clone().to(s.device)
    return out
