"""Gaussian corner targets and the heatmap local maximum; the counterparts
of ``gaussian_radius``, ``render_corner_targets`` and ``local_maximum`` in
erd_tpu/ops/gaussian.py (CornerNet's training targets and its decode).

``render_corner_targets`` draws, for every image, each valid gt's top-left
and bottom-right corners into class heatmaps: a gaussian of radius
floor(gaussian_radius(box)) (sigma (2r + 1) / 6, zero outside the
(2r + 1)^2 square) max-composited into the gt's class channel; at the
corner pixel itself the sub-pixel offset and an offset weight of 1, the
last valid gt at a pixel writing them (erd_tpu's ``fori_loop`` of
``jnp.where`` overwrites). The per-gt scalars (scaled corners, their
integer pixels by truncation, the box size by ``ceil``, the radius in
float32 in erd_tpu's order, sigma's denominator) come from the same torch
code on either path (erd_tpu's values as its jitted loss computes them);
the dense maps come from ``render_corner_targets_plain``
(CPU tensors) or the kernel ``csrc/corner_targets.cu`` (CUDA tensors, one
launch for the batch, counted in ``render_corner_targets.launches``).
Layout: the port's NCHW, heatmaps (B, C, H, W), offsets (B, 2, H, W),
weights (B, 1, H, W), and the corner pixels (B, G, 2) as (x, y).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from . import cuda_build


def local_maximum(heat, kernel: int = 3):
    """Keep the values of (B, C, H, W) ``heat`` that equal the max of their
    kernel x kernel window (padded with -inf), 0 elsewhere."""
    hmax = F.max_pool2d(heat, kernel, stride=1, padding=(kernel - 1) // 2)
    return torch.where(hmax == heat, heat, torch.zeros((), dtype=heat.dtype,
                                                       device=heat.device))


def _f32(v):
    """The float32 nearest ``v``, as a Python float (a tensor times it
    rounds as times a float32 tensor holding it)."""
    return float(torch.tensor(v, dtype=torch.float32))


def gaussian_radius(h, w, min_overlap=0.3):
    """CornerNet's radius of boxes of float32 size h x w, the least of the
    three closed-form cases, bit for bit as erd_tpu's jitted
    ``gaussian_radius`` computes it: XLA folds each division by a constant
    into a product with its float32 reciprocal and merges chained constant
    factors (w * h * 0.7 / 1.3 * 4 becomes (w * h) * f32(0.7 / 1.3 * 4)),
    so the port multiplies by the same float32 constants in the same
    order. The square roots are taken in float64 and rounded once, which
    gives the correctly rounded float32 root that XLA's is (torch's
    vectorised CPU root may be an ulp off)."""
    def sqrt0(v):
        return torch.sqrt(v.clamp(min=0.0).double()).float()

    k1 = _f32(_f32(1 - min_overlap) / _f32(1 + min_overlap)) * 4
    k3 = _f32(1 / _f32(2 * _f32(4 * min_overlap)))
    b1 = h + w
    r1 = (b1 - sqrt0(b1 * b1 - (w * h) * k1)) * 0.5
    b2 = b1 * 2.0
    r2 = (b2 - sqrt0(b2 * b2 - ((w * (1 - min_overlap)) * h) * 16.0)) * 0.125
    b3 = b1 * (-2 * min_overlap)
    c3 = (w * (min_overlap - 1)) * h
    r3 = (-b3 + sqrt0(b3 * b3 - c3 * (4 * (4 * min_overlap)))) * k3
    return torch.minimum(torch.minimum(r1, r2), r3)


def corner_scalars(gt_bboxes, gt_labels, gt_mask, feat_hw, num_classes,
                   ratio, min_overlap=0.3) -> Dict[str, torch.Tensor]:
    """The per-gt scalars of both corners, each (B, G): ``tl_x``, ``tl_y``,
    ``br_x``, ``br_y`` (int64 pixels: the scaled corners capped at the last
    pixel and truncated), ``tl_off`` / ``br_off`` (B, G, 2) float32 sub-pixel
    offsets, ``radius`` (int64), ``denom`` (2 sigma^2 + 1e-12, float32),
    ``label`` (int64, clipped into range) and ``valid`` (bool).

    gt_bboxes (B, G, 4) xyxy in image units; ratio (w_ratio, h_ratio) =
    feature / image size, Python floats."""
    fh, fw = feat_hw
    rx, ry = _f32(ratio[0]), _f32(ratio[1])
    box = gt_bboxes.float()
    sl, st = box[..., 0] * rx, box[..., 1] * ry
    sr, sb = box[..., 2] * rx, box[..., 3] * ry
    li = sl.clamp(max=fw - 1).to(torch.int32).long()
    ri = sr.clamp(max=fw - 1).to(torch.int32).long()
    ti = st.clamp(max=fh - 1).to(torch.int32).long()
    bi = sb.clamp(max=fh - 1).to(torch.int32).long()
    bw, bh = torch.ceil(sr - sl), torch.ceil(sb - st)
    radius = torch.floor(gaussian_radius(bh, bw, min_overlap)).clamp(
        min=0.0).to(torch.int32).long()
    # erd_tpu's 2 sigma^2 + 1e-12 with sigma = (2r + 1) / 6, as XLA folds
    # it: (2r + 1)^2 * f32(2 * f32(1 / 6)^2) + 1e-12
    sixth = _f32(1 / 6)
    side = 2.0 * radius.float() + 1.0
    denom = side * side * _f32(2 * sixth * sixth) + 1e-12
    return dict(
        tl_x=li, tl_y=ti, br_x=ri, br_y=bi,
        tl_off=torch.stack([sl - li, st - ti], -1),
        br_off=torch.stack([sr - ri, sb - bi], -1),
        radius=radius, denom=denom,
        label=gt_labels.long().clamp(0, num_classes - 1),
        valid=gt_mask.bool())


def render_corner_targets_plain(sc, feat_hw, num_classes):
    """Plain PyTorch version of the kernel: the scalars of
    ``corner_scalars`` -> dict(tl_heat, br_heat (B, C, H, W), tl_off,
    br_off (B, 2, H, W), tl_w, br_w (B, 1, H, W)), erd_tpu's loop over the
    gts in order: g = exp(-(dx * dx + dy * dy) / denom) inside the radius,
    maxed into the class channel; the offset and weight overwritten at the
    corner pixel."""
    fh, fw = feat_hw
    b, g = sc['valid'].shape
    dev = sc['valid'].device
    ys = torch.arange(fh, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(fw, dtype=torch.float32, device=dev)[None, :]
    rows = torch.arange(b, device=dev)
    out = {}
    for corner in ('tl', 'br'):
        heat = torch.zeros((b, num_classes, fh, fw), device=dev)
        off = torch.zeros((b, 2, fh, fw), device=dev)
        weight = torch.zeros((b, 1, fh, fw), device=dev)
        for j in range(g):
            cx = sc[f'{corner}_x'][:, j, None, None]
            cy = sc[f'{corner}_y'][:, j, None, None]
            r = sc['radius'][:, j, None, None]
            ok = sc['valid'][:, j, None, None]
            dy, dx = ys - cy.float(), xs - cx.float()
            gauss = torch.exp(-(dx * dx + dy * dy) /
                              sc['denom'][:, j, None, None])
            inside = (dy.abs() <= r) & (dx.abs() <= r) & ok
            gauss = torch.where(inside, gauss, torch.zeros((), device=dev))
            lab = sc['label'][:, j]
            heat[rows, lab] = torch.maximum(heat[rows, lab], gauss)
            at = ((ys == cy) & (xs == cx) & ok)[:, None]
            off = torch.where(at, sc[f'{corner}_off'][:, j, :, None, None],
                              off)
            weight = torch.where(at, torch.ones((), device=dev), weight)
        out.update({f'{corner}_heat': heat, f'{corner}_off': off,
                    f'{corner}_w': weight})
    return out


def render_corner_targets(gt_bboxes, gt_labels, gt_mask, feat_hw,
                          num_classes, ratio, min_overlap=0.3):
    """CornerNet's corner targets of a batch.

    Args:
        gt_bboxes: (B, G, 4) float32 xyxy in image units (padded).
        gt_labels, gt_mask: (B, G) labels and validity.
        feat_hw: (H, W) of the stride-4 corner maps.
        ratio: (w_ratio, h_ratio) = feature / image size.
    Returns dict(tl_heat, br_heat (B, C, H, W), tl_off, br_off (B, 2, H, W),
    tl_w, br_w (B, 1, H, W) float32, tl_xy, br_xy (B, G, 2) int64 (x, y)).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if gt_bboxes.dim() != 3 or gt_bboxes.shape[-1] != 4 or \
            gt_labels.shape != gt_bboxes.shape[:2] or \
            gt_mask.shape != gt_bboxes.shape[:2]:
        raise ValueError(f'render_corner_targets: gt_bboxes (B, G, 4), '
                         f'labels and mask (B, G) expected, got '
                         f'{tuple(gt_bboxes.shape)}, {tuple(gt_labels.shape)}'
                         f', {tuple(gt_mask.shape)}')
    sc = corner_scalars(gt_bboxes, gt_labels, gt_mask, feat_hw, num_classes,
                        ratio, min_overlap)
    xy = {f'{c}_xy': torch.stack([sc[f'{c}_x'], sc[f'{c}_y']], -1)
          for c in ('tl', 'br')}
    dev = gt_bboxes.device
    if dev.type == 'cpu':
        return dict(render_corner_targets_plain(sc, feat_hw, num_classes),
                    **xy)
    if dev.type != 'cuda':
        raise RuntimeError(f'render_corner_targets: no kernel for {dev}')
    fh, fw = feat_hw
    b, g = gt_mask.shape
    ints = torch.stack([sc[k].long() for k in (
        'tl_x', 'tl_y', 'br_x', 'br_y', 'radius', 'label', 'valid')],
        -1).to(torch.int32).contiguous()                       # (B, G, 7)
    floats = torch.cat([sc['tl_off'], sc['br_off'], sc['denom'][..., None]],
                       -1).contiguous()                        # (B, G, 5)
    out = {f'{c}_heat': torch.zeros((b, num_classes, fh, fw), device=dev)
           for c in ('tl', 'br')}
    out.update({f'{c}_off': torch.zeros((b, 2, fh, fw), device=dev)
                for c in ('tl', 'br')})
    out.update({f'{c}_w': torch.zeros((b, 1, fh, fw), device=dev)
                for c in ('tl', 'br')})
    lib = cuda_build.load('corner_targets')
    fn = lib.erd_render_corner_targets
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ints.data_ptr(), floats.data_ptr(),
                 *[out[k].data_ptr() for k in ('tl_heat', 'br_heat', 'tl_off',
                                               'br_off', 'tl_w', 'br_w')],
                 b, g, num_classes, fh, fw, stream)
    cuda_build.check(lib, err, 'render_corner_targets')
    render_corner_targets.launches += 1
    out.update(xy)
    return out


render_corner_targets.launches = 0
