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
``fused_erd_distill`` takes it for CPU tensors and runs the Triton kernel
below, forward and backward, for CUDA tensors.

Kernel design (Triton, sm_90a). Bound on this card: bytes. A call needs,
per row, the 40 student and 40 teacher old-class logits where the row is
selected (ERS-cls, ~2-5 % of rows) or kept (the NMS-kept ERS-reg rows), the
68 student and 68 teacher distribution logits of kept rows, and the two
masks of every row: at B = 16, N = 22400 about 1 MB of masks plus a few MB
of logits, a few microseconds at 3.35 TB/s. The forward kernel runs one
program per (32 rows, image), loads a row's logits only where a mask
needs them (masked loads, no gather), keeps every intermediate in
registers and writes three partial sums per program; a one-program-per-
image second pass adds them in a fixed order (deterministic) and forms the
two per-image losses. The backward kernel recomputes the softmaxes and
writes the gradients of the old-class and distribution logits in one pass
(zero on rows no mask selects). Teacher inputs get no gradient.
"""
import torch

from ..losses import knowledge_distillation_kl_div_loss, l2_response_loss
from ..losses.utils import EPS
from . import cuda_build

ROWS = 32

# Bound when the Triton kernels are first built (_build); the module needs no
# triton at import time.
triton = tl = None
_distill_kernel = _distill_reduce_kernel = None


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


def _build():
    """Define the Triton kernels (once, at first use)."""
    global triton, tl, _distill_kernel, _distill_reduce_kernel
    if _distill_kernel is not None:
        return
    triton, tl = cuda_build.import_triton()

    @triton.jit
    def _distill_kernel(s_cls_ptr, s_row_stride, t_cls_ptr, s_reg_ptr,
                        t_reg_ptr, cm_ptr, kept_ptr, part_ptr, gout_ptr,
                        den_ptr, g_cls_ptr, g_reg_ptr, N, C, nblk, T,
                        ld_weight, eps, BACKWARD: tl.constexpr,
                        NBINS: tl.constexpr, ROWS: tl.constexpr,
                        BLOCK_C: tl.constexpr, BLOCK_B: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        r = pid * ROWS + tl.arange(0, ROWS)
        rmask = r < N
        rows64 = b.to(tl.int64) * N + r.to(tl.int64)
        cm = (tl.load(cm_ptr + rows64, mask=rmask, other=0) != 0) & rmask
        kp = (tl.load(kept_ptr + rows64, mask=rmask, other=0) != 0) & rmask

        # old-class logits, (ROWS, BLOCK_C): the student's where either mask
        # needs them, the teacher's where the row is ERS-cls selected
        cc = tl.arange(0, BLOCK_C)[None, :]
        cval = cc < C
        s_m = (cm | kp)[:, None] & cval
        xs = tl.load(s_cls_ptr + rows64[:, None] * s_row_stride + cc,
                     mask=s_m, other=0.0)
        xt = tl.load(t_cls_ptr + rows64[:, None] * C + cc,
                     mask=cm[:, None] & cval, other=0.0)
        diff = tl.where(cm[:, None] & cval, xs - xt, 0.0)
        sig = 1.0 / (1.0 + tl.exp(-xs))
        w = tl.max(tl.where(cval, sig, float('-inf')), axis=1)
        w = tl.where(kp, w, 0.0)

        # distribution logits of kept rows, (ROWS, 4 corners, BLOCK_B bins)
        side = tl.arange(0, 4)[None, :, None]
        jj = tl.arange(0, BLOCK_B)[None, None, :]
        jval = jj < NBINS
        roff = rows64[:, None, None] * (4 * NBINS) + side * NBINS + jj
        m3 = kp[:, None, None] & jval
        ys = tl.load(s_reg_ptr + roff, mask=m3, other=0.0) / T
        yt = tl.load(t_reg_ptr + roff, mask=m3, other=0.0) / T
        ys = tl.where(jval, ys, float('-inf'))
        yt = tl.where(jval, yt, float('-inf'))
        ms = tl.max(ys, axis=2)
        es = tl.exp(ys - ms[:, :, None])
        ses = tl.sum(es, axis=2)
        mt = tl.max(yt, axis=2)
        et = tl.exp(yt - mt[:, :, None])
        tgt = et / tl.sum(et, axis=2)[:, :, None]

        if not BACKWARD:
            log_p = ys - ms[:, :, None] - tl.log(ses)[:, :, None]
            log_t = tl.log(tl.maximum(tgt, 1e-30))
            elem = tl.where(tgt > 0, tgt * (log_t - log_p), -tgt * log_p)
            elem = tl.where(jval, elem, 0.0)
            kd = tl.sum(elem, axis=2) / NBINS * (T * T)  # (ROWS, 4)
            kd_row = tl.sum(kd, axis=1) * w
            out = part_ptr + (b * nblk + pid) * 3
            tl.store(out, tl.sum(tl.sum(diff * diff, axis=1), axis=0))
            tl.store(out + 1, tl.sum(cm.to(tl.float32), axis=0))
            tl.store(out + 2, tl.sum(tl.where(kp, kd_row, 0.0), axis=0))
        else:
            g_cls = tl.load(gout_ptr + b * 2)
            g_reg = tl.load(gout_ptr + b * 2 + 1)
            den = tl.load(den_ptr + b)
            gc = diff * (2.0 * g_cls / den)
            tl.store(g_cls_ptr + rows64[:, None] * C + cc, gc,
                     mask=rmask[:, None] & cval)
            p = es / ses[:, :, None]
            st = tl.sum(tl.where(jval, tgt, 0.0), axis=2)
            k = g_reg * ld_weight / (4.0 + eps) * T / NBINS
            gr = (p * st[:, :, None] - tgt) * (w * k)[:, None, None]
            gr = tl.where(m3, gr, 0.0)
            tl.store(g_reg_ptr + roff, gr, mask=rmask[:, None, None] & jval)

    @triton.jit
    def _distill_reduce_kernel(part_ptr, nblk, C, out_ptr, den_ptr,
                               ld_weight, eps, BLOCK: tl.constexpr):
        b = tl.program_id(0)
        offs = tl.arange(0, BLOCK)
        a0 = tl.zeros((BLOCK,), tl.float32)
        a1 = tl.zeros((BLOCK,), tl.float32)
        a2 = tl.zeros((BLOCK,), tl.float32)
        for start in range(0, nblk, BLOCK):
            i = start + offs
            m = i < nblk
            base = part_ptr + (b * nblk + i) * 3
            a0 += tl.load(base, mask=m, other=0.0)
            a1 += tl.load(base + 1, mask=m, other=0.0)
            a2 += tl.load(base + 2, mask=m, other=0.0)
        den = tl.maximum(tl.sum(a1, axis=0) * C, 1.0)
        tl.store(out_ptr + b * 2, tl.sum(a0, axis=0) / den)
        tl.store(out_ptr + b * 2 + 1,
                 ld_weight * tl.sum(a2, axis=0) / (4.0 + eps))
        tl.store(den_ptr + b, den)


def _launch(args, backward, gout=None, den=None):
    """One launch of the row kernel; returns (partials, g_cls, g_reg)."""
    s_cls, s_reg, t_cls, t_reg, cm, kept, T, ld_weight, reg_max = args
    b, n, c = t_cls.shape
    nbins = reg_max + 1
    nblk = triton.cdiv(n, ROWS)
    dev = t_cls.device
    part = torch.empty((b, nblk, 3), dtype=torch.float32, device=dev)
    g_cls = g_reg = part
    if backward:
        g_cls = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        g_reg = torch.empty_like(s_reg)
    _distill_kernel[(nblk, b)](
        s_cls, s_cls.stride(1), t_cls, s_reg, t_reg, cm, kept, part,
        gout if backward else part, den if backward else part, g_cls, g_reg,
        n, c, nblk, float(T), float(ld_weight), EPS, BACKWARD=backward,
        NBINS=nbins, ROWS=ROWS, BLOCK_C=triton.next_power_of_2(c),
        BLOCK_B=triton.next_power_of_2(nbins), num_warps=4)
    return part, g_cls, g_reg


class _FusedERDDistill(torch.autograd.Function):

    @staticmethod
    def forward(ctx, s_cls, s_reg, t_cls, t_reg, cm, kept, T, ld_weight,
                reg_max):
        args = (s_cls, s_reg, t_cls, t_reg, cm, kept, T, ld_weight, reg_max)
        part, _, _ = _launch(args, backward=False)
        b = t_cls.shape[0]
        out = torch.empty((b, 2), dtype=torch.float32, device=t_cls.device)
        den = torch.empty((b,), dtype=torch.float32, device=t_cls.device)
        _distill_reduce_kernel[(b,)](part, part.shape[1], t_cls.shape[2],
                                     out, den, float(ld_weight), EPS,
                                     BLOCK=1024, num_warps=4)
        fused_erd_distill.launches += 1
        ctx.args = args
        ctx.save_for_backward(den)
        return out[:, 0], out[:, 1]

    @staticmethod
    def backward(ctx, g_cls, g_reg):
        (den,) = ctx.saved_tensors
        gout = torch.stack([g_cls, g_reg], dim=1).float().contiguous()
        _, gc, gr = _launch(ctx.args, backward=True, gout=gout, den=den)
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

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel: one forward and one backward call, each counted in
    ``fused_erd_distill.launches``.
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
    _build()
    return _FusedERDDistill.apply(
        s_cls[..., :c], s_reg.contiguous(), t_cls.detach().contiguous(),
        t_reg.detach().contiguous(), cls_mask.contiguous().view(torch.uint8),
        kept.contiguous().view(torch.uint8), T, ld_weight, reg_max)


fused_erd_distill.launches = 0
