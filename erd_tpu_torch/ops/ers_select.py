"""ERS (Elastic Response Selection) of the ERD distillation: the dense cls
mask and the capped reg candidate list of each image; kernel
``csrc/ers_select.cu``.

The counterpart of erd_tpu/models/detectors/gfl_erd.py ``ers_cls_mask_dense``
(:96) and the reg selection of ``erd_distill_losses`` (:135-142), over
erd_tpu/ops/misc.py ``masked_mean_std`` and ``topk_mask_select``:

  * cls: c = max sigmoid of the teacher's class logits of a row; a row is
    selected when c > mean + 2 * std over the image's N rows (sample std);
  * reg: r = max of the row's distribution logits; the top-``cap`` rows by
    r (descending, equal values lowest row first, +0 before -0 as
    ``lax.top_k`` ranks them) and the mask of those with r > mean + 2 *
    std; ``count`` masked slots per image.

Teacher logits are bf16 values in float32, so equal criteria are common:
the order is a stable descending sort, never ``torch.topk``. The kernel
selects on a unique 64-bit key (the criterion, then the complemented row
index), so the ties fall in that order and the list holds exactly ``cap``
rows; ``csrc/ers_select.cu`` has its design.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .misc import masked_mean_std, topk_mask_select


def ers_threshold(crit):
    """(B, N) criteria -> (B,) mean + 2 * sample std of each image."""
    mean, std = masked_mean_std(crit, torch.ones_like(crit, dtype=torch.bool))
    return mean + 2 * std


def ers_cls_mask_dense(cls_scores):
    """(B, N, C) teacher logits -> (B, N) bool: max sigmoid > mu + 2 sigma,
    no cap."""
    max_scores = torch.sigmoid(cls_scores).amax(dim=-1)
    return max_scores > ers_threshold(max_scores)[:, None]


def ers_select_plain(t_cls, t_reg, cap):
    """Plain PyTorch version of the ERS kernel (same arguments)."""
    cls_mask = ers_cls_mask_dense(t_cls)
    crit = t_reg.amax(dim=-1)
    reg_idx, reg_mask = topk_mask_select(crit, cap,
                                         ers_threshold(crit)[:, None])
    return cls_mask, reg_idx, reg_mask, reg_mask.sum(dim=-1)


def ers_select(t_cls, t_reg, cap):
    """ERS of a batch of teacher outputs.

    Args:
        t_cls: (B, N, C) float32 teacher class logits.
        t_reg: (B, N, 4*(reg_max+1)) float32 teacher distribution logits.
        cap: length of the reg candidate list, <= N.
    Returns (cls_mask (B, N) bool, reg_idx (B, cap) int64, reg_mask
    (B, cap) bool, count (B,) integer number of masked slots).

    CPU tensors take the plain version; CUDA tensors launch the kernels
    (one call of three launches, counted once in ``ers_select.launches``).
    """
    if t_cls.dim() != 3 or t_reg.dim() != 3 or \
            t_cls.shape[:2] != t_reg.shape[:2]:
        raise ValueError('t_cls (B, N, C) and t_reg (B, N, R) expected')
    b, n = t_cls.shape[:2]
    if not 1 <= cap <= n:
        raise ValueError(f'cap must be in [1, {n}], got {cap}')
    if t_cls.device.type == 'cpu':
        return ers_select_plain(t_cls, t_reg, cap)
    if t_cls.device.type != 'cuda':
        raise RuntimeError(f'ers_select: no kernel for {t_cls.device}')
    if t_reg.device != t_cls.device:
        raise ValueError('ers_select: all tensors must be on one device')
    if t_cls.dtype != torch.float32 or t_reg.dtype != torch.float32:
        raise TypeError('ers_select: t_cls and t_reg must be float32')
    t_cls, t_reg = t_cls.contiguous(), t_reg.contiguous()
    dev = t_cls.device
    lib = cuda_build.load('ers_select')
    lib.erd_ers_blocks.argtypes = [ctypes.c_int]
    lib.erd_ers_blocks.restype = ctypes.c_int
    crit = torch.empty((b, n), dtype=torch.float32, device=dev)
    keys = torch.empty((b, n), dtype=torch.int32, device=dev)
    part = torch.empty((b, lib.erd_ers_blocks(n), 6), dtype=torch.float32,
                       device=dev)
    thr = torch.empty((b, 2), dtype=torch.float32, device=dev)
    grp = torch.empty((b, cap), dtype=torch.int64, device=dev)
    seg = torch.empty((b, cap, 2), dtype=torch.int32, device=dev)
    cls_mask = torch.empty((b, n), dtype=torch.bool, device=dev)
    reg_idx = torch.empty((b, cap), dtype=torch.int64, device=dev)
    reg_mask = torch.empty((b, cap), dtype=torch.bool, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    fn = lib.erd_ers_select
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(t_cls.data_ptr(), t_reg.data_ptr(), b, n, t_cls.shape[2],
                 t_reg.shape[2], cap, crit.data_ptr(), keys.data_ptr(),
                 part.data_ptr(), thr.data_ptr(), grp.data_ptr(),
                 seg.data_ptr(), cls_mask.data_ptr(), reg_idx.data_ptr(),
                 reg_mask.data_ptr(), count.data_ptr(), stream)
    cuda_build.check(lib, err, 'ers_select')
    ers_select.launches += 1
    return cls_mask, reg_idx, reg_mask, count


ers_select.launches = 0
