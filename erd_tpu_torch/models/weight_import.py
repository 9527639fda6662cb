"""Weight import into the port's GFL, VFNet, Faster R-CNN (and its mask
variants), DETR-family and CornerNet networks; the counterpart of
erd_tpu/models/weight_import.py.

The port's GFL, VFNet and Faster R-CNN modules carry the mmdet state-dict
names, so an mmdet checkpoint loads with a plain ``load_state_dict`` (not a
DCNv2 one: see ``load_torch_checkpoint_file``), and the port's GFL
``state_dict`` reads back into erd_tpu with its ``load_mmdet_state_dict``.
erd_tpu's Deformable DETR and DINO are not mmdet's architecture (no sine
positional encoding, one shared ``fc_cls``, ...): their port keeps
erd_tpu's scope names and loads no mmdet file.
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
    dcn_offset = mod[1:] == ('conv2', 'conv_offset')
    if m is None or not (len(mod) == 2 or dcn_offset):
        raise KeyError(f'unmapped backbone module {"/".join(mod)}')
    sub = {'downsample_conv': 'downsample.0',
           'downsample_bn': 'downsample.1'}.get(mod[1], '.'.join(mod[1:]))
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
    m = re.fullmatch(r'carafe_(\d+)', name)
    if m and len(mod) == 2:  # FPN_CARAFE: the CARAFEPack upsampling lateral i
        return f'neck.upsample_modules.{int(m.group(1)) - 1}.{mod[1]}'
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


def _vfnet_head_module(mod: Tuple[str, ...], leaf: str) -> str:
    """VFNet head scopes -> mmdet's names; the two deformable kernels are
    bare parameters of the head (module path ())."""
    if not mod:
        m = re.fullmatch(r'(reg_refine|cls)_dconv_kernel', leaf)
        if m:
            return f'bbox_head.vfnet_{m.group(1)}_dconv'
    elif mod[0] in ('vfnet_reg_conv', 'vfnet_reg', 'vfnet_reg_refine',
                    'vfnet_cls'):
        return '.'.join(('bbox_head',) + mod)
    else:
        m = re.fullmatch(r'scale(_refine)?_(\d+)', mod[0])
        if m:
            return f'bbox_head.scales{m.group(1) or ""}.{m.group(2)}'
        return _head_module(mod)
    raise KeyError(f'unmapped head parameter {"/".join(mod + (leaf,))}')


def _rcnn_module(scope: str, mod: Tuple[str, ...]) -> str:
    """Faster R-CNN's ``rpn_head`` and ``bbox_head`` scopes."""
    if scope == 'rpn_head' and mod[0] in ('rpn_conv', 'rpn_cls', 'rpn_reg'):
        return f'rpn_head.{mod[0]}'
    m = re.fullmatch(r'shared_fc(\d+)', mod[0])
    if scope == 'bbox_head' and m:
        return f'roi_head.bbox_head.shared_fcs.{m.group(1)}'
    if scope == 'bbox_head' and mod[0] in ('fc_cls', 'fc_reg'):
        return f'roi_head.bbox_head.{mod[0]}'
    m = re.fullmatch(r'(fc_cls|fc_reg)_(\d+)', mod[0])
    if scope == 'bbox_head' and m:  # CrowdDet's instance k
        return f'roi_head.bbox_head.{m.group(1)}.{m.group(2)}'
    raise KeyError(f'unmapped {scope} module {"/".join(mod)}')


def _mask_module(scope: str, mod: Tuple[str, ...]) -> str:
    """Mask R-CNN's ``mask_head`` (``conv_i``, ``upsample``,
    ``conv_logits``) and PointRend's ``coarse_mask_head`` (``conv{i}``,
    ``fc{i}``, ``fc_logits``) and ``point_head`` (``fc{i}``,
    ``fc_logits``) scopes."""
    head = 'point_head' if scope == 'point_head' else 'mask_head'
    m = re.fullmatch(r'(conv|fc)_?(\d+)', mod[0])
    if m and scope == 'mask_head':
        return f'roi_head.mask_head.convs.{m.group(2)}.conv'
    if m:
        return f'roi_head.{head}.{m.group(1)}s.{m.group(2)}'
    if mod[0] in ('upsample', 'conv_logits', 'fc_logits'):
        return f'roi_head.{head}.{mod[0]}'
    raise KeyError(f'unmapped {scope} module {"/".join(mod)}')


def _detr_neck_module(mod: Tuple[str, ...]) -> str:
    """ChannelMapper scopes (``conv_i``, ``gn_i``, ``extra_conv_k``,
    ``extra_gn_k``) keep their names."""
    if len(mod) == 1 and re.fullmatch(r'(extra_)?(conv|gn)_\d+', mod[0]):
        return f'neck.{mod[0]}'
    raise KeyError(f'unmapped neck module {"/".join(mod)}')


def _detr_head_value(mod: Tuple[str, ...], leaf: str, v: np.ndarray):
    """A DETR head leaf as the port's tensor: dense kernels (I, O) ->
    (O, I); DenseGeneral kernels (C, heads, hd) -> (heads*hd, C) and the
    attention ``out`` kernel (heads, hd, C) -> (C, heads*hd); (heads, hd)
    biases flattened. Embeddings are copied as they are."""
    if leaf == 'kernel' and v.ndim == 3:
        if mod[-1] == 'out':
            return v.reshape(-1, v.shape[-1]).T
        return v.reshape(v.shape[0], -1).T
    if leaf == 'kernel':
        return v.T
    if leaf == 'bias' and v.ndim == 2:
        return v.reshape(-1)
    return v


def _shared_fc0_rows(kernel: np.ndarray, roi_size: int = 7) -> np.ndarray:
    """erd_tpu's first fc kernel (roi*roi*C, O), rows in (h, w, c) order,
    -> the (O, C*roi*roi) weight of mmdet's channel-major flatten."""
    rows, out = kernel.shape
    c = rows // (roi_size * roi_size)
    k = kernel.reshape(roi_size, roi_size, c, out)
    return np.transpose(k, (3, 2, 0, 1)).reshape(out, c * roi_size ** 2)


def _conv_transpose_weight(kernel: np.ndarray) -> np.ndarray:
    """flax's ConvTranspose kernel (kh, kw, I, O), applied without a flip
    (output (2i + a, 2j + b) takes tap (1 - a, 1 - b)), -> torch's
    ConvTranspose2d weight (I, O, kh, kw), which takes tap (a, b)."""
    return np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1))


def _leaf(leaf: str, module: str, collection: str) -> str:
    if collection == 'batch_stats':
        return {'mean': 'running_mean', 'var': 'running_var'}[leaf]
    if leaf in ('kernel', 'embedding') or leaf.endswith('_dconv_kernel'):
        return 'weight'
    if leaf == 'scale':  # norm gamma, or the per-level Scale parameter
        return 'scale' if re.search(r'\.scales(_refine)?\.', module) \
            else 'weight'
    return leaf


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """erd_tpu GFL, VFNet, Faster R-CNN (FPN or FPN_CARAFE), Mask R-CNN,
    PointRend, CrowdDet, Deformable DETR, DINO or CornerNet variables
    {'params', 'batch_stats'} (nested numpy dicts) -> the port's network's
    ``state_dict``.

    Conv kernels go from (kh, kw, I, O) to (O, I, kh, kw), dense kernels
    from (I, O) to (O, I); the R-CNN head's first fc also reorders its
    input rows from erd_tpu's (7, 7, C) flatten to mmdet's (C, 7, 7). GN/BN
    ``scale`` becomes ``weight``; frozen-BN ``mean``/``var`` become
    ``running_mean``/``running_var``. In the DETR heads, module paths are
    erd_tpu's scopes, DenseGeneral kernels are flattened over their
    (heads, hd) axes, and the level and query embeddings keep their names.
    A deformable conv's ``conv_offset`` keeps erd_tpu's channel order, and
    VFNet's bare ``*_dconv_kernel`` parameters become the weights of
    ``vfnet_*_dconv``. FPN_CARAFE's ``neck/chain0`` scopes map to
    ``neck.lateral_convs.i``, ``neck.upsample_modules.{i-1}`` (``carafe_i``,
    its ``content_encoder`` rows in erd_tpu's order) and
    ``neck.fpn_convs.j``; CrowdDet's ``fc_cls_k`` / ``fc_reg_k`` to
    ``roi_head.bbox_head.fc_cls.k`` / ``fc_reg.k``. Mask R-CNN's
    ``mask_head`` maps to mmdet's ``roi_head.mask_head`` names (the
    ``upsample`` kernel's taps flipped into torch's ConvTranspose2d
    layout); PointRend's ``coarse_mask_head`` to ``roi_head.mask_head``
    (``convs``, ``fcs`` with ``fc0``'s rows from (14, 14, C) to (C, 14,
    14), ``fc_logits``) and ``point_head`` to ``roi_head.point_head``.
    CornerNet's scopes keep their names, its BN ``batch_stats`` becoming
    the running statistics. The weights go one way: erd_tpu has no
    importer of Faster R-CNN, VFNet, DETR, mask-head or CornerNet state
    dicts.
    """
    params = variables['params']
    neck = params.get('neck', {})
    # a swapped neck (FPN_CARAFE) sits under erd_tpu's NeckChain scope
    chain = 'chain0' in neck
    neck = neck.get('chain0', neck)
    n_fpn = sum(1 for k in neck if k.startswith('fpn_conv_'))
    start_level = min((int(k[len('lateral_'):]) for k in neck
                       if k.startswith('lateral_')), default=0)
    two_stage = 'rpn_head' in params
    cornernet = 'tl_pool_0' in params
    detr = 'level_embed_0' in params.get('bbox_head', {})
    vfnet = 'vfnet_cls' in params.get('bbox_head', {})
    out = {}
    for collection in ('params', 'batch_stats'):
        for path, value in _flatten(variables.get(collection, {})):
            scope, mod, leaf = path[0], path[1:-1], path[-1]
            v = np.asarray(value, np.float32)
            if detr and scope == 'bbox_head':
                module = '.'.join(('bbox_head',) + mod)
                v = _detr_head_value(mod, leaf, v)
                key = f'{module}.{_leaf(leaf, module, collection)}' \
                    if mod else f'{module}.{leaf}'
                out[key] = torch.from_numpy(np.array(v, order='C'))
                continue
            if cornernet:  # the port keeps erd_tpu's scope names
                module = '.'.join((scope,) + mod)
            elif scope == 'backbone':
                module = _backbone_module(mod)
            elif scope == 'neck' and detr:
                module = _detr_neck_module(mod)
            elif scope == 'neck':
                module = _neck_module(mod[1:] if chain else mod, n_fpn,
                                      start_level)
            elif two_stage and scope in ('rpn_head', 'bbox_head'):
                module = _rcnn_module(scope, mod)
            elif two_stage and scope in ('mask_head', 'coarse_mask_head',
                                         'point_head'):
                module = _mask_module(scope, mod)
            elif vfnet and scope == 'bbox_head':
                module = _vfnet_head_module(mod, leaf)
            elif scope == 'bbox_head':
                module = _head_module(mod)
            else:
                raise KeyError(f'unmapped scope {"/".join(path)}')
            if v.ndim == 4 and module.endswith('mask_head.upsample'):
                v = _conv_transpose_weight(v)
            elif v.ndim == 4:  # conv kernels, the bare dconv ones too
                v = np.transpose(v, (3, 2, 0, 1))
            elif leaf == 'kernel' and module.endswith('shared_fcs.0'):
                v = _shared_fc0_rows(v)
            elif leaf == 'kernel' and module.endswith('mask_head.fcs.0'):
                v = _shared_fc0_rows(v, 14)  # PointRend's coarse head
            elif leaf == 'kernel' and v.ndim == 2:
                v = v.T
            key = f'{module}.{_leaf(leaf, module, collection)}'
            out[key] = torch.from_numpy(np.array(v, order='C'))
    return out


def batch_stats_to_jax(net: nn.Module) -> Dict:
    """CornerNet's BN running statistics -> erd_tpu's nested
    ``batch_stats`` ({scope: {...: {'bn': {'mean', 'var'}}}} of numpy
    float32): the inverse of ``params_from_jax``'s ``batch_stats`` branch
    for the hourglass and the corner pools, whose module paths are
    erd_tpu's scopes. Holds the running statistics that train-mode BN
    updated against erd_tpu's ``new_state['batch_stats']``."""
    names = {'running_mean': 'mean', 'running_var': 'var'}
    out: Dict = {}
    for key, value in net.state_dict().items():
        *path, leaf = key.split('.')
        if leaf not in names:
            continue
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[names[leaf]] = value.detach().cpu().float().numpy()
    return out


def load_torch_checkpoint_file(net: nn.Module, path: str):
    """Load an mmdet ``.pth`` into ``net`` (GFL, VFNet, Faster R-CNN, Mask
    R-CNN or CrowdDet) in place; raises for the DETR family, PointRend and
    CornerNet, whose port follows erd_tpu's architecture and not mmdet's,
    for a network with modulated
    deformable convs (DCNv2), whose ``conv_offset`` layout is not mmcv's,
    and for an FPN_CARAFE neck, whose ``content_encoder`` rows are not in
    mmcv's order.

    The file is unpickled (``weights_only=False``, as mmdet checkpoints
    carry metadata objects): load only trusted checkpoints. ``module.``
    prefixes and BN ``num_batches_tracked`` counters are dropped.
    Returns the result of ``load_state_dict``.
    """
    from .detectors.cornernet import CornerNetNet
    from .detectors.deformable_detr import DETRNet
    from .detectors.point_rend import PointRendNet
    if isinstance(net, (CornerNetNet, PointRendNet)):
        raise NotImplementedError(
            f"{type(net).__name__} keeps erd_tpu's architecture and scope "
            "names (PointRend's coarse head has no downsampling conv, "
            "CornerNet's modules are erd_tpu's scopes): no mmdet checkpoint "
            "loads into it; use params_from_jax")
    if isinstance(net, DETRNet):
        raise NotImplementedError(
            "erd_tpu's Deformable DETR and DINO are not mmdet's architecture "
            '(no sine positional encoding, one shared fc_cls, no padding '
            'mask): no mmdet checkpoint loads into them; use params_from_jax')
    from ..ops.deform_conv import ModulatedDeformConv
    if any(isinstance(m, ModulatedDeformConv) and m.modulated
           for m in net.modules()):
        raise NotImplementedError(
            "modulated deformable convs (DCNv2) do not load from an mmdet "
            "checkpoint: mmcv's ModulatedDeformConv2dPack orders conv_offset's"
            " output channels as [all (dy, dx) pairs | all masks], while "
            "erd_tpu, and the port after it, interleave (dy, dx, mask) per "
            "kernel point, and erd_tpu's importer has no conv_offset mapping "
            "(ROADMAP.md, section 3); use params_from_jax")
    from ..ops.carafe import CARAFEPack
    if any(isinstance(m, CARAFEPack) for m in net.modules()):
        raise NotImplementedError(
            "an FPN_CARAFE neck does not load from an mmdet checkpoint: "
            "mmcv's CARAFEPack pixel-shuffles content_encoder's output "
            "channels in the order k * up^2 + a * up + b (tap k of sub-pixel "
            "(a, b)), while erd_tpu, and the port after it, read them as "
            "(a * up + b) * k_up^2 + k, and erd_tpu's importer has no "
            "CARAFE mapping (ROADMAP.md, section 3); use params_from_jax")
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
