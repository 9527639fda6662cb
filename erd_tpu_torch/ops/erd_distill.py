"""Fused ERD distillation loss: L2 on the ERS-selected old-class logits and
KD-KL on the NMS-kept distribution logits, per image.

The counterpart of erd_tpu/models/detectors/gfl_erd.py ``distill_single``
(:178-196) with erd_tpu/losses/kd_loss.py ``l2_response_loss`` and
``knowledge_distillation_kl_div_loss`` (:17,40), vmapped over the batch. Per
image b, with C the teacher's classes:

    l_cls[b] = sum over rows with cls_mask of (s_cls[:, :C] - t_cls)^2
               / max(C * rows, 1)
    w        = kept * max_j sigmoid(s_cls[:, :C]) (detached)
    kd       = T^2 * mean over the bins of KL(softmax(t / T) || softmax(s / T))
               for each of the 4 corners of a row (teacher detached,
               0 * log 0 = 0)
    l_reg[b] = ld_weight * sum(w * kd) / (4 + eps)

``erd_distill_plain`` is that formulation in plain PyTorch (autograd);
``fused_erd_distill`` takes it for CPU tensors and runs the CUDA kernels of
``csrc/erd_distill.cu``, forward and backward, for CUDA tensors.

Kernel design (CUDA, sm_90a; the source's header has the details). Bound
on this card: bytes. A row matters only where one of its masks is set (a
few per cent of the rows), so the forward reads every row's two mask bytes
and the logits of selected rows only; the backward writes the gradient of
the whole student class map and of the distribution logits for every row,
~0.21 GB at B = 16, N = 22400 and an 80-wide map (~0.065 ms at 3.35 TB/s).
A warp owns 8 rows and a lane a (row, side) pair; a warp with no selected
row skips every load and transcendental and, in the backward, writes its
rows' zeros as 16-byte stores. The forward's per-block partials are added
in a fixed order by a second pass, a block an image (deterministic). The
backward writes the class gradient the whole width of ``s_cls`` (zeros
past the teacher's C columns), so that autograd adds no zero-fill and no
slice copy around the call. Teacher inputs and the weight w get no
gradient.
"""
import ctypes

import torch

from ..losses import knowledge_distillation_kl_div_loss, l2_response_loss
from ..losses.utils import EPS
from . import cuda_build


def erd_distill_plain(s_cls, s_reg, t_cls, t_reg, cls_mask, kept, T=10.0,
                      ld_weight=0.25, reg_max=16):
    """Plain PyTorch version of the fused distillation (same arguments).
    Returns (l_cls (B,), l_reg (B,))."""
    b, n, c = t_cls.shape
    s_old = s_cls[..., :c]
    sq = l2_response_loss(s_old, t_cls, mask=cls_mask[..., None],
                          reduction='none')
    rows = cls_mask.sum(dim=1).to(sq.dtype)
    l_cls = sq.sum(dim=(1, 2)) / (c * rows).clamp(min=1.0)
    w = torch.sigmoid(s_old.detach()).amax(dim=-1)
    w = torch.where(kept, w, torch.zeros_like(w))
    kd = knowledge_distillation_kl_div_loss(
        s_reg.reshape(b * n * 4, reg_max + 1),
        t_reg.reshape(b * n * 4, reg_max + 1), T=T, reduction='none')
    w4 = w[..., None].expand(b, n, 4)
    l_reg = ld_weight * (kd.reshape(b, n, 4) * w4).sum(dim=(1, 2)) / \
        (4.0 + EPS)
    return l_cls, l_reg


def _launch(lib, fn, args, *extra):
    """Call the C entry point ``fn`` on the forward's arguments, then
    ``extra`` and the stream; raise on a CUDA error."""
    s_cls, s_reg, t_cls, t_reg, cm, kept, T, ld_weight, reg_max = args
    b, n, c = t_cls.shape
    with torch.cuda.device(t_cls.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(s_cls.data_ptr(), s_cls.stride(1), s_cls.shape[2],
                 s_reg.data_ptr(), t_cls.data_ptr(), t_reg.data_ptr(),
                 cm.data_ptr(), kept.data_ptr(), b, n, c, reg_max + 1,
                 float(T), float(ld_weight), EPS,
                 *(t.data_ptr() for t in extra), stream)
    cuda_build.check(lib, err, 'fused_erd_distill')


def _library():
    lib = cuda_build.load('erd_distill')
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [vp, ctypes.c_longlong, ci] + [vp] * 5 + [ci] * 4 + [cf] * 3
    lib.erd_distill_blocks.argtypes = [ci]
    lib.erd_distill_blocks.restype = ci
    lib.erd_distill_forward.argtypes = head + [vp] * 4
    lib.erd_distill_forward.restype = ci
    lib.erd_distill_backward.argtypes = head + [vp] * 5
    lib.erd_distill_backward.restype = ci
    return lib


class _FusedERDDistill(torch.autograd.Function):

    @staticmethod
    def forward(ctx, s_cls, s_reg, t_cls, t_reg, cm, kept, T, ld_weight,
                reg_max):
        args = (s_cls, s_reg, t_cls, t_reg, cm, kept, T, ld_weight, reg_max)
        lib = _library()
        b, n = t_cls.shape[:2]
        dev = t_cls.device
        part = torch.empty((b, lib.erd_distill_blocks(n), 3),
                           dtype=torch.float32, device=dev)
        out = torch.empty((b, 2), dtype=torch.float32, device=dev)
        den = torch.empty((b,), dtype=torch.float32, device=dev)
        _launch(lib, lib.erd_distill_forward, args, part, out, den)
        fused_erd_distill.launches += 1
        ctx.args = args
        ctx.save_for_backward(den)
        return out[:, 0], out[:, 1]

    @staticmethod
    def backward(ctx, g_cls, g_reg):
        (den,) = ctx.saved_tensors
        s_cls, s_reg = ctx.args[:2]
        gout = torch.stack([g_cls, g_reg], dim=1).float().contiguous()
        gc = torch.empty(s_cls.shape, dtype=torch.float32,
                         device=s_cls.device)
        gr = torch.empty_like(s_reg)
        lib = _library()
        _launch(lib, lib.erd_distill_backward, ctx.args, gout, den, gc, gr)
        fused_erd_distill.launches += 1
        return (gc, gr) + (None,) * 7


def fused_erd_distill(s_cls, s_reg, t_cls, t_reg, cls_mask, kept, T=10.0,
                      ld_weight=0.25, reg_max=16):
    """ERD distillation losses of a batch, per image.

    Args:
        s_cls: (B, N, >= C) float32 student class logits; its first C
            channels (the teacher's classes) are used. May be a view with a
            row stride, last dim contiguous.
        s_reg: (B, N, 4*(reg_max+1)) float32 student distribution logits.
        t_cls: (B, N, C) float32 teacher class logits (no gradient).
        t_reg: (B, N, 4*(reg_max+1)) float32 teacher distribution logits.
        cls_mask: (B, N) bool ERS-cls selection.
        kept: (B, N) bool NMS-kept ERS-reg rows.
    Returns (l_cls (B,), l_reg (B,)), differentiable in ``s_cls`` and
    ``s_reg``.

    CPU tensors take the plain version; CUDA tensors launch the kernels:
    one forward and one backward call, each counted in
    ``fused_erd_distill.launches``. The backward writes the gradient of
    the whole ``s_cls`` (zeros past its first C columns).
    """
    b, n, c = t_cls.shape
    nbins = reg_max + 1
    if s_cls.dim() != 3 or tuple(s_cls.shape[:2]) != (b, n) or \
            s_cls.shape[2] < c:
        raise ValueError('s_cls must be (B, N, >= C) for t_cls (B, N, C)')
    if tuple(s_reg.shape) != (b, n, 4 * nbins) or \
            tuple(t_reg.shape) != (b, n, 4 * nbins):
        raise ValueError(f's_reg and t_reg must be (B, N, {4 * nbins})')
    if tuple(cls_mask.shape) != (b, n) or tuple(kept.shape) != (b, n):
        raise ValueError('cls_mask and kept must be (B, N)')
    if s_cls.device.type == 'cpu':
        return erd_distill_plain(s_cls, s_reg, t_cls, t_reg, cls_mask, kept,
                                 T, ld_weight, reg_max)
    if s_cls.device.type != 'cuda':
        raise RuntimeError(f'fused_erd_distill: no kernel for {s_cls.device}')
    tensors = (s_reg, t_cls, t_reg, cls_mask, kept)
    if any(t.device != s_cls.device for t in tensors):
        raise ValueError('fused_erd_distill: all tensors must be on one '
                         'device')
    if any(t.dtype != torch.float32 for t in (s_cls, s_reg, t_cls, t_reg)):
        raise TypeError('fused_erd_distill: logits must be float32')
    if cls_mask.dtype != torch.bool or kept.dtype != torch.bool:
        raise TypeError('fused_erd_distill: cls_mask and kept must be bool')
    if s_cls.stride(2) != 1 or s_cls.stride(0) != n * s_cls.stride(1):
        raise ValueError('fused_erd_distill: s_cls rows must be evenly '
                         'strided with a contiguous class dim')
    return _FusedERDDistill.apply(
        s_cls, s_reg.contiguous(), t_cls.detach().contiguous(),
        t_reg.detach().contiguous(), cls_mask.contiguous().view(torch.uint8),
        kept.contiguous().view(torch.uint8), T, ld_weight, reg_max)


fused_erd_distill.launches = 0
