"""Fused GFL dense loss: QFL + GIoU + DFL over every anchor row.

The counterpart of erd_tpu/models/heads/gfl_head.py ``gfl_loss`` (:211-263)
with ``integral`` (ops/integral.py:14), ``quality_focal_loss`` and
``distribution_focal_loss`` (losses/gfocal.py:18,71) and ``giou_loss``
(losses/iou_loss.py:39). ``gfl_loss_plain`` is that formulation in plain
PyTorch, differentiated by autograd. ``fused_gfl_loss`` takes it for CPU
tensors and, for CUDA tensors, runs the CUDA kernels of
``csrc/gfl_loss.cu``, forward and backward, through a
``torch.autograd.Function``.

Per anchor row (stride-normalised frame): the softmax expectation over the
4 x (reg_max + 1) bins gives the corner distances, the decoded box and, with
the box target, the detached IoU quality of positives; QFL over the C class
logits (weighted by the label weight); GIoU of decoded vs target and DFL of
the four sides, each weighted by the detached max sigmoid of positives.
loss_cls = qfl_w * sum / (max(num_pos, 1) + eps), loss_bbox = bbox_w *
sum / max(sum wt, 1), loss_dfl = dfl_w * sum / (4 + eps) / max(sum wt, 1).

Kernel design (CUDA C++ for sm_90a; the source's note has it whole). Bound
on this card: bytes. A row that is not positive has quality 0 and weight
0, so its loss and gradients depend on its class logits alone: the
kernels read the distribution logits and box targets of positive rows
only (0.2-0.3 % of the rows at the training calls), ~280 MB for a
forward and backward at B = 16, N = 22400, 40 classes: ~84 us at 3.35
TB/s. A warp owns 8 rows, a lane a (row, side) pair: lane s takes the
16-byte chunks s, s + 4, ... of its row's classes (single classes where C
or the row stride is not a multiple of 4), read in place through the
class map's row stride (a slice of a wider map is not copied); a warp
with a positive row softmaxes each side's bins in its lane and exchanges
the corners by quad shuffles. The forward reduces
per block in a fixed order and a one-block pass forms the three losses and
the two normalisers, which stay on the device for the backward
(deterministic, no atomics). The backward recomputes each row's forward
values and writes both gradients; no tie or detach differs from the
reference's autodiff: quality and the weights are detached, and max/min
split an exact tie 1/2 : 1/2 as jax.lax.max does.
"""
import ctypes

import torch

from ..losses import (distribution_focal_loss, giou_loss,
                      quality_focal_loss)
from ..losses.utils import EPS
from ..structures.boxes import bbox2distance, bbox_overlaps, distance2bbox
from . import cuda_build
from .integral import integral


def gfl_loss_plain(cls, reg, labels, label_weights, bbox_targets, pos_mask,
                   num_pos, centers, strides, qfl_weight=1.0, qfl_beta=2.0,
                   bbox_weight=2.0, dfl_weight=0.25, reg_max=16):
    """Plain PyTorch version of the fused GFL loss (same arguments).
    Returns (loss_cls, loss_bbox, loss_dfl), 0-dim tensors."""
    b, n, c = cls.shape
    centers_n = centers[None] / strides[None, :, None]
    avg_cls = num_pos.clamp(min=1.0)
    corners = integral(reg, reg_max)
    decoded = distance2bbox(centers_n, corners)
    targets_n = bbox_targets / strides[None, :, None]
    quality = bbox_overlaps(decoded.detach(), targets_n, is_aligned=True)
    quality = torch.where(pos_mask, quality, torch.zeros_like(quality))
    loss_cls = qfl_weight * quality_focal_loss(
        cls.reshape(b * n, c), (labels.reshape(-1), quality.reshape(-1)),
        weight=label_weights.reshape(-1), beta=qfl_beta, avg_factor=avg_cls)
    wt = torch.sigmoid(cls.detach()).amax(dim=-1)
    wt = torch.where(pos_mask, wt, torch.zeros_like(wt))
    avg_reg = wt.sum().clamp(min=1.0)
    lb = giou_loss(decoded.reshape(-1, 4), targets_n.reshape(-1, 4),
                   reduction='none')
    loss_bbox = bbox_weight * (lb * wt.reshape(-1)).sum() / avg_reg
    corner_targets = bbox2distance(centers_n, targets_n, max_dis=reg_max,
                                   eps=0.1)
    dfl = distribution_focal_loss(reg.reshape(b * n * 4, reg_max + 1),
                                  corner_targets.reshape(-1),
                                  reduction='none')
    wt4 = wt[..., None].expand(b, n, 4).reshape(-1)
    loss_dfl = dfl_weight * (dfl * wt4).sum() / (4.0 + EPS) / avg_reg
    return loss_cls, loss_bbox, loss_dfl


def _launch(name, args, extra, outs):
    """One call of the C entry point ``name`` on ``args`` (the autograd
    Function's), with ``extra`` (num_pos, or the losses' gradients and the
    forward's stats) and the output pointers ``outs``."""
    (cls, reg, labels, lw, bt, pos, _, centers, strides, weights,
     reg_max) = args
    qfl_w, beta, bbox_w, dfl_w = weights
    b, n, c = cls.shape
    lib = cuda_build.load('gfl_loss')
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] +
                   [ctypes.c_void_p] * (7 + len(extra)) + [ctypes.c_int] * 4 +
                   [ctypes.c_float] * 5 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    with torch.cuda.device(cls.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cls.data_ptr(), cls.stride(1), reg.data_ptr(),
                 labels.data_ptr(), lw.data_ptr(), bt.data_ptr(),
                 pos.data_ptr(), centers.data_ptr(), strides.data_ptr(),
                 *(t.data_ptr() for t in extra), b, n, c, reg_max + 1,
                 float(beta), float(qfl_w), float(bbox_w), float(dfl_w),
                 EPS, *(t.data_ptr() for t in outs), stream)
    cuda_build.check(lib, err, f'fused_gfl_loss ({name})')


class _FusedGFLLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cls, reg, labels, lw, bt, pos, num_pos, centers,
                strides, weights, reg_max):
        args = (cls, reg, labels, lw, bt, pos, num_pos, centers, strides,
                weights, reg_max)
        lib = cuda_build.load('gfl_loss')
        lib.erd_gfl_loss_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.erd_gfl_loss_blocks.restype = ctypes.c_longlong
        blocks = lib.erd_gfl_loss_blocks(cls.shape[0], cls.shape[1])
        part = torch.empty((max(blocks, 1), 4), dtype=torch.float32,
                           device=cls.device)
        out = torch.empty(5, dtype=torch.float32, device=cls.device)
        _launch('erd_gfl_loss_forward', args, (num_pos,), (part, out))
        fused_gfl_loss.launches += 1
        ctx.args = args
        ctx.save_for_backward(out)
        return out[0], out[1], out[2]

    @staticmethod
    def backward(ctx, g_cls, g_bbox, g_dfl):
        (stats,) = ctx.saved_tensors
        cls, reg = ctx.args[:2]
        gout = torch.stack([g_cls, g_bbox, g_dfl]).float().contiguous()
        gcls = torch.empty(cls.shape, dtype=torch.float32, device=cls.device)
        greg = torch.empty_like(reg)
        _launch('erd_gfl_loss_backward', ctx.args, (gout, stats),
                (gcls, greg))
        fused_gfl_loss.launches += 1
        return (gcls, greg) + (None,) * 9


def fused_gfl_loss(cls, reg, labels, label_weights, bbox_targets, pos_mask,
                   num_pos, centers, strides, qfl_weight=1.0, qfl_beta=2.0,
                   bbox_weight=2.0, dfl_weight=0.25, reg_max=16):
    """GFL loss of a batch over its flattened anchor rows.

    Args:
        cls: (B, N, C) float32 class logits; may be a view with a row
            stride (e.g. the new-class slice of a wider map), last dim
            contiguous.
        reg: (B, N, 4*(reg_max+1)) float32 distribution logits.
        labels: (B, N) int64, C = background.
        label_weights: (B, N) float32.
        bbox_targets: (B, N, 4) float32 xyxy targets (image frame).
        pos_mask: (B, N) bool.
        num_pos: 0-dim float32 positive count of the batch.
        centers: (N, 2) float32 anchor centres; strides: (N,) float32.
    Returns (loss_cls, loss_bbox, loss_dfl), 0-dim tensors, differentiable
    in ``cls`` and ``reg``.

    CPU tensors take the plain version; CUDA tensors launch the CUDA
    kernels: one forward and one backward call, each counted in
    ``fused_gfl_loss.launches``.
    """
    b, n, c = cls.shape
    if tuple(reg.shape) != (b, n, 4 * (reg_max + 1)):
        raise ValueError(f'reg must be (B, N, {4 * (reg_max + 1)}), got '
                         f'{tuple(reg.shape)}')
    if tuple(labels.shape) != (b, n) or tuple(pos_mask.shape) != (b, n) or \
            tuple(label_weights.shape) != (b, n) or \
            tuple(bbox_targets.shape) != (b, n, 4):
        raise ValueError('labels, label_weights, pos_mask (B, N) and '
                         'bbox_targets (B, N, 4) expected')
    if tuple(centers.shape) != (n, 2) or tuple(strides.shape) != (n,):
        raise ValueError('centers (N, 2) and strides (N,) expected')
    weights = (qfl_weight, qfl_beta, bbox_weight, dfl_weight)
    if cls.device.type == 'cpu':
        return gfl_loss_plain(cls, reg, labels, label_weights, bbox_targets,
                              pos_mask, num_pos, centers, strides, *weights,
                              reg_max=reg_max)
    if cls.device.type != 'cuda':
        raise RuntimeError(f'fused_gfl_loss: no kernel for {cls.device}')
    tensors = (reg, labels, label_weights, bbox_targets, pos_mask, num_pos,
               centers, strides)
    if any(t.device != cls.device for t in tensors):
        raise ValueError('fused_gfl_loss: all tensors must be on one device')
    if any(t.dtype != torch.float32 for t in (cls, reg, label_weights,
                                             bbox_targets, num_pos, centers,
                                             strides)):
        raise TypeError('fused_gfl_loss: logits, weights, targets, num_pos '
                        'and geometry must be float32')
    if cls.stride(2) != 1 or cls.stride(0) != n * cls.stride(1):
        raise ValueError('fused_gfl_loss: cls rows must be evenly strided '
                         'with a contiguous class dim')
    if not float(qfl_beta) > 0:
        raise ValueError('fused_gfl_loss: qfl_beta must be positive')
    return _FusedGFLLoss.apply(
        cls, reg.contiguous(), labels.long().contiguous(),
        label_weights.contiguous(), bbox_targets.contiguous(),
        pos_mask.contiguous().view(torch.uint8), num_pos.reshape(()),
        centers.contiguous(), strides.contiguous(), weights, reg_max)


fused_gfl_loss.launches = 0
