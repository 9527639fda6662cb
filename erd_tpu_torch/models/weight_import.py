"""Weight import into the port's GFL network; the counterpart of
erd_tpu/models/weight_import.py.

The port's modules carry the mmdet state-dict names, so an mmdet GFL
checkpoint loads with a plain ``load_state_dict`` and the port's
``state_dict`` reads back into erd_tpu with its ``load_mmdet_state_dict``.
``params_from_jax`` converts erd_tpu's variables (as nested numpy dicts)
into the port's ``state_dict``.
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


def _neck_module(mod: Tuple[str, ...], n_fpn: int) -> str:
    name = mod[0]
    m = re.fullmatch(r'lateral_(\d+)', name)
    if m:  # erd_tpu numbers laterals by input level (start_level=1)
        return f'neck.lateral_convs.{int(m.group(1)) - 1}.conv'
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


def _leaf(leaf: str, module: str, collection: str) -> str:
    if collection == 'batch_stats':
        return {'mean': 'running_mean', 'var': 'running_var'}[leaf]
    if leaf == 'kernel':
        return 'weight'
    if leaf == 'scale':  # norm gamma, or the per-level Scale parameter
        return 'scale' if '.scales.' in module else 'weight'
    return leaf


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """erd_tpu GFL variables {'params', 'batch_stats'} (nested numpy
    dicts) -> the port's GFLNet ``state_dict``.

    Conv kernels go from (kh, kw, I, O) to (O, I, kh, kw); GN/BN ``scale``
    becomes ``weight``; frozen-BN ``mean``/``var`` become
    ``running_mean``/``running_var``.
    """
    n_fpn = sum(1 for k in variables['params'].get('neck', {})
                if k.startswith('fpn_conv_'))
    out = {}
    for collection in ('params', 'batch_stats'):
        for path, value in _flatten(variables.get(collection, {})):
            scope, mod, leaf = path[0], path[1:-1], path[-1]
            if scope == 'backbone':
                module = _backbone_module(mod)
            elif scope == 'neck':
                module = _neck_module(mod, n_fpn)
            elif scope == 'bbox_head':
                module = _head_module(mod)
            else:
                raise KeyError(f'unmapped scope {"/".join(path)}')
            v = np.asarray(value, np.float32)
            if leaf == 'kernel' and v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            key = f'{module}.{_leaf(leaf, module, collection)}'
            out[key] = torch.from_numpy(np.array(v, order='C'))
    return out


def load_torch_checkpoint_file(net: nn.Module, path: str):
    """Load an mmdet GFL ``.pth`` into ``net`` in place.

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
