"""Instance-mask targets; the counterpart of erd_tpu/data/masks.py.

Ground-truth masks ride through a batch as fixed-size box-normalised crops:
one (R, R) uint8 bitmap per gt slot (R = 56), its extent the gt box
(``GTInstances.masks``). The mask head's targets are the crops resampled to
each sampled RoI: ``crop_resize_mask`` maps the centres of an out x out grid
over the RoI into the crop's frame, takes the edge-clamped bilinear sample
there, and zeroes the cells that fall outside the gt box (Detectron's
crop-and-resize targets). Rasterising polygons into the crops needs cv2 and
comes with the data pipeline (``polygons_to_boxmask`` is not ported yet).

The arithmetic is erd_tpu's as XLA compiles it on the CPU, where its tests
run: the division by ``out`` becomes a product with the float32
reciprocal, and LLVM contracts three multiply-adds into fused ones (the
sample position lo + t * (hi - lo), the crop coordinate q * R - 0.5, and
the last three terms of the bilinear sum). The plain version rounds each
fused multiply-add once (``_fma``: the exact float64 product and sum,
rounded to float32), the kernel uses ``fmaf``; so a floor near an integer
lands where erd_tpu's does and the targets equal erd_tpu's to the bit.

``crop_resize_mask`` takes a batch: every sampled RoI of every image with
the index of its assigned gt. CPU tensors take ``crop_resize_mask_plain``;
CUDA tensors launch the kernel ``csrc/mask_target.cu`` (one launch for the
batch, counted in ``crop_resize_mask.launches``).
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from ..ops import cuda_build


def pad_gt_masks(masks: List[np.ndarray], max_gt: int,
                 mask_res: int = 56) -> np.ndarray:
    """(max_gt, mask_res, mask_res) uint8: the crops, then zero slots."""
    out = np.zeros((max_gt, mask_res, mask_res), np.uint8)
    for i, m in enumerate(masks[:max_gt]):
        out[i] = m
    return out


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a fused multiply-add)."""
    return (a.double() * b.double() + c.double()).float()


def _grid(lo, hi, out_size):
    """erd_tpu's sample centres lo + (i + 0.5) / out * (hi - lo), (..., out)
    float32."""
    inv = torch.tensor(1.0, dtype=torch.float32) / out_size
    t = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv
    return _fma(t.to(lo.device), (hi - lo)[..., None], lo[..., None])


def _crop_axis(pos, lo, extent, r):
    """Coordinates of ``pos`` (..., out) in a crop of r cells spanning
    [lo, lo + extent): (the two clipped indices, the upper weight, inside
    the crop), in erd_tpu's arithmetic."""
    m = _fma((pos - lo[..., None]) / extent[..., None],
             torch.tensor(float(r)), torch.tensor(-0.5))
    f = torch.floor(m)
    i0 = f.to(torch.int64).clamp(0, r - 1)
    i1 = (i0 + 1).clamp(0, r - 1)
    inside = (m >= -0.5) & (m <= r - 0.5)
    return i0, i1, m - f, inside


def crop_resize_mask_plain(gt_masks, gt_boxes, gt_idx, rois, out_size=28):
    """Plain PyTorch version of the kernel: gt_masks (B, G, R, R) uint8,
    gt_boxes (B, G, 4), gt_idx (B, S) in [0, G), rois (B, S, 4) -> (B, S,
    out, out) float32 targets, erd_tpu's ``crop_resize_mask`` on every
    (RoI, its gt) pair: gw = max(gx2 - gx1, 1e-3), my = (ys - gy1) / gh * R
    - 0.5, indices floor(my) and floor(my) + 1 clipped into [0, R), the sum
    v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) +
    v11 * wy * wx left to right (the last three terms fused), times (my, mx
    in [-0.5, R - 0.5])."""
    b, s = gt_idx.shape
    r = gt_masks.shape[-1]
    idx = gt_idx.long()
    box = torch.gather(gt_boxes.float(), 1, idx[..., None].expand(b, s, 4))
    crop = torch.gather(gt_masks, 1, idx[..., None, None].expand(
        b, s, r, r)).float()
    gw = (box[..., 2] - box[..., 0]).clamp(min=1e-3)
    gh = (box[..., 3] - box[..., 1]).clamp(min=1e-3)
    y0, y1, wy, in_y = _crop_axis(_grid(rois[..., 1], rois[..., 3],
                                        out_size), box[..., 1], gh, r)
    x0, x1, wx, in_x = _crop_axis(_grid(rois[..., 0], rois[..., 2],
                                        out_size), box[..., 0], gw, r)
    flat = crop.reshape(b, s, r * r)

    def corner(yi, xi):
        at = (yi[..., :, None] * r + xi[..., None, :]).reshape(b, s, -1)
        return torch.gather(flat, 2, at).reshape(b, s, out_size, out_size)

    wyc, wxc = wy[..., :, None], wx[..., None, :]
    out = corner(y0, x0) * (1 - wyc) * (1 - wxc)
    out = _fma(corner(y0, x1) * (1 - wyc), wxc, out)
    out = _fma(corner(y1, x0) * wyc, 1 - wxc, out)
    out = _fma(corner(y1, x1) * wyc, wxc, out)
    return out * (in_y[..., :, None] & in_x[..., None, :]).to(out.dtype)


def crop_resize_mask(gt_masks, gt_boxes, gt_idx, rois, out_size=28):
    """Mask targets of the sampled RoIs.

    Args:
        gt_masks: (B, G, R, R) uint8 box-normalised gt crops.
        gt_boxes: (B, G, 4) float32 xyxy gt boxes (the crops' extents).
        gt_idx: (B, S) integer index of each RoI's gt, in [0, G).
        rois: (B, S, 4) float32 xyxy sampled RoIs.
    Returns (B, S, out_size, out_size) float32 targets in [0, 1].

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    b, s = gt_idx.shape
    if gt_masks.dim() != 4 or gt_masks.shape[:2] != gt_boxes.shape[:2] or \
            gt_masks.shape[2] != gt_masks.shape[3] or \
            tuple(rois.shape) != (b, s, 4) or gt_masks.shape[0] != b:
        raise ValueError(
            f'crop_resize_mask: gt_masks (B, G, R, R), gt_boxes (B, G, 4), '
            f'gt_idx (B, S) and rois (B, S, 4) expected, got '
            f'{tuple(gt_masks.shape)}, {tuple(gt_boxes.shape)}, '
            f'{tuple(gt_idx.shape)}, {tuple(rois.shape)}')
    if rois.device.type == 'cpu':
        return crop_resize_mask_plain(gt_masks, gt_boxes, gt_idx, rois,
                                      out_size)
    if rois.device.type != 'cuda':
        raise RuntimeError(f'crop_resize_mask: no kernel for {rois.device}')
    if gt_masks.dtype != torch.uint8 or gt_boxes.dtype != torch.float32 or \
            rois.dtype != torch.float32:
        raise TypeError('crop_resize_mask: uint8 masks, float32 boxes and '
                        'rois expected')
    if any(t.device != rois.device for t in (gt_masks, gt_boxes, gt_idx)):
        raise ValueError('crop_resize_mask: all inputs on one device')
    g, r = gt_masks.shape[1], gt_masks.shape[-1]
    masks = gt_masks.contiguous()
    boxes = gt_boxes.contiguous()
    idx = gt_idx.to(torch.int32).contiguous()
    rois = rois.contiguous()
    out = torch.empty((b, s, out_size, out_size), dtype=torch.float32,
                      device=rois.device)
    lib = cuda_build.load('mask_target')
    fn = lib.erd_crop_resize_mask
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(masks.data_ptr(), boxes.data_ptr(), idx.data_ptr(),
                 rois.data_ptr(), out.data_ptr(), b, s, g, r, out_size,
                 stream)
    cuda_build.check(lib, err, 'crop_resize_mask')
    crop_resize_mask.launches += 1
    return out


crop_resize_mask.launches = 0
