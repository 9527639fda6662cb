"""Fused GFL dense loss: QFL + GIoU + DFL over every anchor row.

The counterpart of erd_tpu/models/heads/gfl_head.py ``gfl_loss`` (:211-263)
with ``integral`` (ops/integral.py:14), ``quality_focal_loss`` and
``distribution_focal_loss`` (losses/gfocal.py:18,71) and ``giou_loss``
(losses/iou_loss.py:39). ``gfl_loss_plain`` is that formulation in plain
PyTorch, differentiated by autograd. ``fused_gfl_loss`` takes it for CPU
tensors and, for CUDA tensors, runs the Triton kernel below, forward and
backward, through a ``torch.autograd.Function``.

Per anchor row (stride-normalised frame): the softmax expectation over the
4 x (reg_max + 1) bins gives the corner distances, the decoded box and, with
the box target, the detached IoU quality of positives; QFL over the C class
logits (weighted by the label weight); GIoU of decoded vs target and DFL of
the four sides, each weighted by the detached max sigmoid of positives.
loss_cls = qfl_w * sum / (max(num_pos, 1) + eps), loss_bbox = bbox_w *
sum / max(sum wt, 1), loss_dfl = dfl_w * sum / (4 + eps) / max(sum wt, 1).

Kernel design (Triton, for sm_90a). Bound on this card: bytes. At B = 16,
N = 22400 a call reads 40 class logits of each row (a strided view into
the (B, N, 80) student map), 68 distribution logits, the targets and the
anchor geometry, about 470 B per row, 170 MB in all: ~50 us at 3.35 TB/s;
its ~1.5 kflop per row is far below the fp32 peak. The forward kernel runs
one program per 32 rows and keeps everything of a row in registers: one
read of each logit, no intermediate in device memory, and four per-program
partial sums; a one-program second pass adds the partials in a fixed order
(deterministic) and forms the three losses and the two normalisers, which
stay on the device for the backward. The backward kernel recomputes each
row's forward values (cheaper than storing them) and writes the gradient of
the class and distribution logits in one pass; no tie or detach differs
from the reference's autodiff: quality and the weights are detached, and
max/min split an exact tie 1/2 : 1/2 as jax.lax.max does.
"""
import torch

from ..losses import (distribution_focal_loss, giou_loss,
                      quality_focal_loss)
from ..losses.utils import EPS
from ..structures.boxes import bbox2distance, bbox_overlaps, distance2bbox
from . import cuda_build
from .integral import integral

ROWS = 32

# Bound when the Triton kernels are first built (_build); the module needs no
# triton at import time.
triton = tl = None
_gfl_loss_kernel = _gfl_reduce_kernel = None


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


def _build():
    """Define the Triton kernels (once, at first use)."""
    global triton, tl, _gfl_loss_kernel, _gfl_reduce_kernel
    if _gfl_loss_kernel is not None:
        return
    triton, tl = cuda_build.import_triton()

    @triton.jit
    def _gfl_loss_kernel(cls_ptr, cls_stride, reg_ptr, lab_ptr, lw_ptr,
                         bt_ptr, pos_ptr, ctr_ptr, str_ptr, out_ptr,
                         gout_ptr, stat_ptr, gcls_ptr, greg_ptr, M, N, C,
                         dmax, beta, qfl_w, bbox_w, dfl_w, eps,
                         BACKWARD: tl.constexpr, BETA2: tl.constexpr,
                         NBINS: tl.constexpr, ROWS: tl.constexpr,
                         BLOCK_C: tl.constexpr, BLOCK_B: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * ROWS + tl.arange(0, ROWS)
        rmask = rows < M
        rows64 = rows.to(tl.int64)
        a = rows % N
        lab = tl.load(lab_ptr + rows64, mask=rmask, other=-1)
        lw = tl.load(lw_ptr + rows64, mask=rmask, other=0.0)
        pos = tl.load(pos_ptr + rows64, mask=rmask, other=0) != 0
        st = tl.load(str_ptr + a, mask=rmask, other=1.0)
        cx = tl.load(ctr_ptr + 2 * a, mask=rmask, other=0.0) / st
        cy = tl.load(ctr_ptr + 2 * a + 1, mask=rmask, other=0.0) / st
        tx1 = tl.load(bt_ptr + 4 * rows64, mask=rmask, other=0.0) / st
        ty1 = tl.load(bt_ptr + 4 * rows64 + 1, mask=rmask, other=0.0) / st
        tx2 = tl.load(bt_ptr + 4 * rows64 + 2, mask=rmask, other=0.0) / st
        ty2 = tl.load(bt_ptr + 4 * rows64 + 3, mask=rmask, other=0.0) / st

        # distribution logits, (ROWS, 4 sides, BLOCK_B bins)
        side = tl.arange(0, 4)[None, :]
        jj = tl.arange(0, BLOCK_B)[None, None, :]
        roff = rows64[:, None, None] * (4 * NBINS) + side[:, :, None] * \
            NBINS + jj
        jval = jj < NBINS
        m3 = rmask[:, None, None] & jval
        x = tl.load(reg_ptr + roff, mask=m3, other=0.0)
        x = tl.where(jval, x, float('-inf'))
        mx = tl.max(x, axis=2)
        e = tl.exp(x - mx[:, :, None])
        se = tl.sum(e, axis=2)
        p = e / se[:, :, None]
        jf = jj.to(tl.float32)
        corner = tl.sum(p * jf, axis=2)  # (ROWS, 4)
        lse = mx + tl.log(se)
        c0 = tl.sum(tl.where(side == 0, corner, 0.0), axis=1)
        c1 = tl.sum(tl.where(side == 1, corner, 0.0), axis=1)
        c2 = tl.sum(tl.where(side == 2, corner, 0.0), axis=1)
        c3 = tl.sum(tl.where(side == 3, corner, 0.0), axis=1)
        px1 = cx - c0
        py1 = cy - c1
        px2 = cx + c2
        py2 = cy + c3

        # IoU quality (eps 1e-6) and the GIoU terms (eps 1e-7)
        wp = tl.maximum(px2 - px1, 0.0)
        hp = tl.maximum(py2 - py1, 0.0)
        ap = wp * hp
        at = tl.maximum(tx2 - tx1, 0.0) * tl.maximum(ty2 - ty1, 0.0)
        ltx = tl.maximum(px1, tx1)
        lty = tl.maximum(py1, ty1)
        rbx = tl.minimum(px2, tx2)
        rby = tl.minimum(py2, ty2)
        iw = tl.maximum(rbx - ltx, 0.0)
        ih = tl.maximum(rby - lty, 0.0)
        ov = iw * ih
        u0 = ap + at - ov
        q = ov / tl.maximum(u0, 1e-6)
        q = tl.where(pos, q, 0.0)
        uni = tl.maximum(u0, 1e-7)
        ex1 = tl.minimum(px1, tx1)
        ey1 = tl.minimum(py1, ty1)
        ex2 = tl.maximum(px2, tx2)
        ey2 = tl.maximum(py2, ty2)
        ew = tl.maximum(ex2 - ex1, 0.0)
        eh = tl.maximum(ey2 - ey1, 0.0)
        ea0 = ew * eh
        ea = tl.maximum(ea0, 1e-7)
        giou = ov / uni - (ea - uni) / ea

        # class logits, (ROWS, BLOCK_C)
        cc = tl.arange(0, BLOCK_C)[None, :]
        cm = rmask[:, None] & (cc < C)
        xc = tl.load(cls_ptr + rows64[:, None] * cls_stride + cc, mask=cm,
                     other=0.0)
        s = 1.0 / (1.0 + tl.exp(-xc))
        ex = tl.exp(-tl.abs(xc))
        u = 1.0 + ex
        l1p = tl.where(u == 1.0, ex, tl.log(u) * (ex / (u - 1.0)))
        relu = tl.maximum(xc, 0.0)
        sp = relu + l1p
        qb = q[:, None]
        bce_q = relu - xc * qb + l1p
        dq = tl.abs(qb - s)
        if BETA2:
            sb = s * s
            db = dq * dq
        else:
            sb = tl.where(s > 0, tl.exp(beta * tl.log(s)), 0.0)
            db = tl.where(dq > 0, tl.exp(beta * tl.log(dq)), 0.0)
        onehot = cc == lab[:, None]
        smax = tl.max(tl.where(cm, s, float('-inf')), axis=1)
        wt = tl.where(pos, smax, 0.0)

        # DFL targets and weights
        t0 = tl.minimum(tl.maximum(cx - tx1, 0.0), dmax)
        t1 = tl.minimum(tl.maximum(cy - ty1, 0.0), dmax)
        t2 = tl.minimum(tl.maximum(tx2 - cx, 0.0), dmax)
        t3 = tl.minimum(tl.maximum(ty2 - cy, 0.0), dmax)
        tt = tl.where(side == 0, t0[:, None],
                      tl.where(side == 1, t1[:, None],
                               tl.where(side == 2, t2[:, None],
                                        t3[:, None])))
        dl = tl.floor(tt)
        wl = dl + 1.0 - tt
        wr = tt - dl
        dli = tl.minimum(tl.maximum(dl.to(tl.int32), 0), NBINS - 1)
        dri = tl.minimum(tl.maximum(dl.to(tl.int32) + 1, 0), NBINS - 1)
        hit_l = jj == dli[:, :, None]
        hit_r = jj == dri[:, :, None]

        if not BACKWARD:
            lrow = tl.where(onehot, bce_q * db, sp * sb)
            qfl = tl.sum(tl.where(cm, lrow, 0.0), axis=1) * lw
            bbox = (1.0 - giou) * wt
            xl = tl.sum(tl.where(hit_l, x, 0.0), axis=2)
            xr = tl.sum(tl.where(hit_r, x, 0.0), axis=2)
            dfl = tl.sum(wl * (lse - xl) + wr * (lse - xr), axis=1) * wt
            tl.store(out_ptr + pid * 4, tl.sum(qfl, axis=0))
            tl.store(out_ptr + pid * 4 + 1, tl.sum(bbox, axis=0))
            tl.store(out_ptr + pid * 4 + 2, tl.sum(dfl, axis=0))
            tl.store(out_ptr + pid * 4 + 3, tl.sum(wt, axis=0))
        else:
            avg_cls = tl.load(stat_ptr + 3)
            avg_reg = tl.load(stat_ptr + 4)
            kc = tl.load(gout_ptr) * (qfl_w / (avg_cls + eps))
            kb = tl.load(gout_ptr + 1) * bbox_w / avg_reg
            kd = tl.load(gout_ptr + 2) * dfl_w / (4.0 + eps) / avg_reg
            # d/dx of sp * s^b and of bce(x, q) * |q - s|^b
            sig = s * (1.0 - s)
            dsq = s - qb
            if BETA2:
                dneg = sb * (s + 2.0 * sp * (1.0 - s))
                dpos = dsq * db + bce_q * 2.0 * dsq * sig
            else:
                dneg = sb * (s + beta * sp * (1.0 - s))
                sgn = tl.where(dsq > 0, 1.0, tl.where(dsq < 0, -1.0, 0.0))
                dpow = tl.where(dq > 0,
                                tl.exp((beta - 1.0) * tl.log(dq)), 0.0)
                dpos = dsq * db + bce_q * beta * dpow * sgn * sig
            gc = tl.where(onehot, dpos, dneg) * (kc * lw)[:, None]
            tl.store(gcls_ptr + rows64[:, None] * C + cc, gc, mask=cm)

            # GIoU backward; w(a, b) is a's share of d max(a, b)
            g = -(kb * wt)
            g_uni = g * (1.0 / ea - ov / (uni * uni))
            g_ov = g / uni
            g_ea = -g * uni / (ea * ea)
            g_u0 = g_uni * tl.where(u0 > 1e-7, 1.0,
                                    tl.where(u0 == 1e-7, 0.5, 0.0))
            g_ap = g_u0
            g_ov = g_ov - g_u0
            g_ea0 = g_ea * tl.where(ea0 > 1e-7, 1.0,
                                    tl.where(ea0 == 1e-7, 0.5, 0.0))
            dxe = ex2 - ex1
            dye = ey2 - ey1
            g_dxe = g_ea0 * eh * tl.where(dxe > 0, 1.0,
                                          tl.where(dxe == 0, 0.5, 0.0))
            g_dye = g_ea0 * ew * tl.where(dye > 0, 1.0,
                                          tl.where(dye == 0, 0.5, 0.0))
            dxi = rbx - ltx
            dyi = rby - lty
            g_dxi = g_ov * ih * tl.where(dxi > 0, 1.0,
                                         tl.where(dxi == 0, 0.5, 0.0))
            g_dyi = g_ov * iw * tl.where(dyi > 0, 1.0,
                                         tl.where(dyi == 0, 0.5, 0.0))
            dxp = px2 - px1
            dyp = py2 - py1
            g_dxp = g_ap * hp * tl.where(dxp > 0, 1.0,
                                         tl.where(dxp == 0, 0.5, 0.0))
            g_dyp = g_ap * wp * tl.where(dyp > 0, 1.0,
                                         tl.where(dyp == 0, 0.5, 0.0))
            # share of p in min(p, t) and in max(p, t)
            lo_x1 = tl.where(px1 < tx1, 1.0, tl.where(px1 == tx1, 0.5, 0.0))
            lo_y1 = tl.where(py1 < ty1, 1.0, tl.where(py1 == ty1, 0.5, 0.0))
            lo_x2 = tl.where(px2 < tx2, 1.0, tl.where(px2 == tx2, 0.5, 0.0))
            lo_y2 = tl.where(py2 < ty2, 1.0, tl.where(py2 == ty2, 0.5, 0.0))
            g_px1 = -g_dxe * lo_x1 - g_dxi * (1.0 - lo_x1) - g_dxp
            g_py1 = -g_dye * lo_y1 - g_dyi * (1.0 - lo_y1) - g_dyp
            g_px2 = g_dxe * (1.0 - lo_x2) + g_dxi * lo_x2 + g_dxp
            g_py2 = g_dye * (1.0 - lo_y2) + g_dyi * lo_y2 + g_dyp
            g_corner = tl.where(side == 0, -g_px1[:, None],
                                tl.where(side == 1, -g_py1[:, None],
                                         tl.where(side == 2, g_px2[:, None],
                                                  g_py2[:, None])))
            g_int = p * (jf - corner[:, :, None]) * g_corner[:, :, None]
            hl = tl.where(hit_l, 1.0, 0.0)
            hr = tl.where(hit_r, 1.0, 0.0)
            g_dfl = ((wl + wr)[:, :, None] * p - wl[:, :, None] * hl -
                     wr[:, :, None] * hr) * (kd * wt)[:, None, None]
            tl.store(greg_ptr + roff, g_int + g_dfl, mask=m3)

    @triton.jit
    def _gfl_reduce_kernel(part_ptr, nblk, npos_ptr, out_ptr, qfl_w, bbox_w,
                           dfl_w, eps, BLOCK: tl.constexpr):
        offs = tl.arange(0, BLOCK)
        a0 = tl.zeros((BLOCK,), tl.float32)
        a1 = tl.zeros((BLOCK,), tl.float32)
        a2 = tl.zeros((BLOCK,), tl.float32)
        a3 = tl.zeros((BLOCK,), tl.float32)
        for start in range(0, nblk, BLOCK):
            i = start + offs
            m = i < nblk
            a0 += tl.load(part_ptr + i * 4, mask=m, other=0.0)
            a1 += tl.load(part_ptr + i * 4 + 1, mask=m, other=0.0)
            a2 += tl.load(part_ptr + i * 4 + 2, mask=m, other=0.0)
            a3 += tl.load(part_ptr + i * 4 + 3, mask=m, other=0.0)
        avg_cls = tl.maximum(tl.load(npos_ptr), 1.0)
        avg_reg = tl.maximum(tl.sum(a3, axis=0), 1.0)
        tl.store(out_ptr, qfl_w * (tl.sum(a0, axis=0) / (avg_cls + eps)))
        tl.store(out_ptr + 1, bbox_w * tl.sum(a1, axis=0) / avg_reg)
        tl.store(out_ptr + 2,
                 dfl_w * tl.sum(a2, axis=0) / (4.0 + eps) / avg_reg)
        tl.store(out_ptr + 3, avg_cls)
        tl.store(out_ptr + 4, avg_reg)


def _launch(args, backward, gout=None, stats=None):
    """One launch of the row kernel; returns (partials, gcls, greg)."""
    (cls, reg, labels, lw, bt, pos, num_pos, centers, strides, weights,
     reg_max) = args
    qfl_w, beta, bbox_w, dfl_w = weights
    b, n, c = cls.shape
    m = b * n
    nbins = reg_max + 1
    grid = (triton.cdiv(m, ROWS),)
    dev = cls.device
    part = torch.empty((grid[0], 4), dtype=torch.float32, device=dev)
    gcls = greg = part
    if backward:
        gcls = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        greg = torch.empty_like(reg)
    _gfl_loss_kernel[grid](
        cls, cls.stride(1), reg, labels, lw, bt, pos, centers, strides,
        part, gout if backward else part, stats if backward else part,
        gcls, greg, m, n, c, float(reg_max) - 0.1, float(beta),
        float(qfl_w), float(bbox_w), float(dfl_w), EPS,
        BACKWARD=backward, BETA2=float(beta) == 2.0, NBINS=nbins,
        ROWS=ROWS, BLOCK_C=triton.next_power_of_2(c),
        BLOCK_B=triton.next_power_of_2(nbins), num_warps=4)
    return part, gcls, greg


class _FusedGFLLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cls, reg, labels, lw, bt, pos, num_pos, centers,
                strides, weights, reg_max):
        args = (cls, reg, labels, lw, bt, pos, num_pos, centers, strides,
                weights, reg_max)
        part, _, _ = _launch(args, backward=False)
        out = torch.empty(5, dtype=torch.float32, device=cls.device)
        _gfl_reduce_kernel[(1,)](part, part.shape[0], num_pos, out,
                                 float(weights[0]), float(weights[2]),
                                 float(weights[3]), EPS, BLOCK=1024,
                                 num_warps=4)
        fused_gfl_loss.launches += 1
        ctx.args = args
        ctx.save_for_backward(out)
        return out[0], out[1], out[2]

    @staticmethod
    def backward(ctx, g_cls, g_bbox, g_dfl):
        (stats,) = ctx.saved_tensors
        gout = torch.stack([g_cls, g_bbox, g_dfl]).float().contiguous()
        _, gcls, greg = _launch(ctx.args, backward=True, gout=gout,
                                stats=stats)
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

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel: one forward and one backward call, each counted in
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
    _build()
    return _FusedGFLLoss.apply(
        cls, reg.contiguous(), labels.long().contiguous(),
        label_weights.contiguous(), bbox_targets.contiguous(),
        pos_mask.contiguous().view(torch.uint8), num_pos.reshape(()),
        centers.contiguous(), strides.contiguous(), weights, reg_max)


fused_gfl_loss.launches = 0
