"""PointRend (R50-FPN) serving and training; the counterpart of
erd_tpu/models/detectors/point_rend.py.

Faster R-CNN's detections; RoIAlign 14x14 of P2-P5 on them (canvas frame);
``CoarseMaskHead`` -> (R, C, 14, 14) logits, of which the detected class's
map is refined by ``subdivision_steps`` rounds: a bilinear x2 upsample
(``F.interpolate``, align_corners=False), the ``subdivision_points`` most
uncertain cells (the top-k of -|logit|, ties lowest index first as
``lax.top_k``), their centres sampled on the coarse logits (the coarse
call of ``point_sample``, all C classes) and on the image's P2 map (the fine
call, all the image's RoIs at once), ``MaskPointHead`` on both, and its
logit of the detected class written back at those cells. ``predict``
returns (DetResults, masks (B, 100, 56, 56) probabilities), as erd_tpu's.

Both ``point_sample`` calls of a step are the kernel ``csrc/point_sample.cu``
on CUDA tensors: 2 steps, 4 launches a request. erd_tpu runs
``extract_feat`` a second time after Faster R-CNN's predict; the port
reuses the features, which are the same.

``loss``: Faster R-CNN's RPN and R-CNN losses on the same sampler draws;
``loss_mask``, the BCE of the coarse head's 14x14 target-class logits on
all 512 sampled RoIs of each image against ``crop_resize_mask``'s 14x14
targets; ``loss_point``, the BCE of the point head at 196
points an RoI against the targets sampled there and thresholded at 0.5:
147 of them the most uncertain (-|coarse logit|, ties lowest index first)
of 588 uniform draws, 49 more uniform draws. Four ``point_sample`` calls a
step (uncertainty and targets without a gradient, the coarse logits and
P2 with one: the backward kernel of ``csrc/point_sample.cu``). The two
uniform draws come after the samplers' four in ``draws``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...ops import point_sample
from ...ops.misc import take_rows, topk_stable
from ...ops.roi_align import _div
from ...structures import DetResults
from ..heads.bbox_head import RoISamples
from ..heads.mask_head import CoarseMaskHead, MaskPointHead, pick_class
from .faster_rcnn import FasterRCNNDetector, ROI_STRIDES, FasterRCNNNet
from .mask_rcnn import MaskRCNNDetector

# PointRend's training points an RoI: NUM_POINTS, of which IMPORTANT are
# the most uncertain of NUM_POINTS * OVERSAMPLE uniform draws
NUM_POINTS, OVERSAMPLE, IMPORTANT = 196, 3, 147


class PointRendNet(FasterRCNNNet):
    """Faster R-CNN's network with ``roi_head.mask_head`` (the coarse head)
    and ``roi_head.point_head``."""

    def __init__(self, num_classes: int, depth: int = 50,
                 frozen_stages: int = -1,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, depth=depth,
                         frozen_stages=frozen_stages,
                         param_dtype=param_dtype)
        self.roi_head.mask_head = CoarseMaskHead(num_classes,
                                                 param_dtype=param_dtype)
        self.roi_head.point_head = MaskPointHead(num_classes,
                                                 param_dtype=param_dtype)


def upsample2x(logits):
    """Bilinear x2 of (R, H, W) maps, align_corners=False: erd_tpu's
    ``jax.image.resize(..., 'bilinear')``. JAX normalises the weights of an
    edge sample's taps (one tap of weight 0.75 -> 1), torch clamps the
    sample coordinate onto the edge pixel: both give the edge pixel's value;
    inside, both weigh neighbours 0.75 / 0.25 (the sums' rounding may
    differ by an ulp)."""
    return F.interpolate(logits[:, None], scale_factor=2, mode='bilinear',
                         align_corners=False)[:, 0]


def cell_centres(idx, size):
    """Flat cell indices (R, K) of a size x size map -> (R, K, 2) (x, y)
    centres in [0, 1]."""
    yy = torch.div(idx, size, rounding_mode='floor').float()
    xx = (idx % size).float()
    return torch.stack([_div(xx + 0.5, size), _div(yy + 0.5, size)], -1)


def fine_points(rois, rel, p2_hw):
    """RoI-relative points (B, D, K, 2) of rois (B, D, 4) -> (B, D * K, 2)
    points normalised to the P2 map of (H, W) ``p2_hw``."""
    x = rois[..., None, 0] + rel[..., 0] * (rois[..., None, 2] -
                                            rois[..., None, 0])
    y = rois[..., None, 1] + rel[..., 1] * (rois[..., None, 3] -
                                            rois[..., None, 1])
    h, w = p2_hw
    stride = float(ROI_STRIDES[0])
    pts = torch.stack([_div(x, w * stride), _div(y, h * stride)], -1)
    return pts.flatten(1, 2)


@dataclass
class PointRendDetector(MaskRCNNDetector):
    """Config + functions of PointRend."""
    subdivision_steps: int = 2
    subdivision_points: int = 196

    def build_net(self) -> PointRendNet:
        return PointRendNet(self.num_classes, depth=self.depth,
                            frozen_stages=self.frozen_stages,
                            param_dtype=self.compute_dtype)

    @torch.no_grad()
    def coarse_logits(self, net: PointRendNet, feats, rois):
        """(B * D, C, 14, 14) float32 coarse logits of rois (B, D, 4)."""
        return net.roi_head.mask_head(
            self.mask_feats(feats, rois).flatten(0, 1)).float()

    @torch.no_grad()
    def subdivide(self, net: PointRendNet, p2, rois, coarse, logits, labels):
        """One subdivision step: (R, S, S) class logits -> (R, 2S, 2S) and
        the flat indices (R, K) of the refined cells."""
        b, d = rois.shape[:2]
        r, size = logits.shape[0], 2 * logits.shape[-1]
        logits = upsample2x(logits)
        kk = min(self.subdivision_points, size * size)
        _, idx = topk_stable(-logits.abs().reshape(r, -1), kk)
        pts = cell_centres(idx, size)                          # (R, kk, 2)
        coarse_pts = point_sample(coarse, pts)                 # (R, kk, C)
        fine = point_sample(p2, fine_points(
            rois, pts.reshape(b, d, kk, 2), p2.shape[-2:]))    # (B, D*kk, C')
        plog = net.roi_head.point_head(fine.reshape(r, kk, -1),
                                       coarse_pts).float()
        picked = torch.gather(plog, 2, labels.long().clamp(
            0, plog.shape[-1] - 1)[:, None, None].expand(r, kk, 1))[..., 0]
        logits = logits.reshape(r, -1).scatter(1, idx, picked)
        return logits.reshape(r, size, size), idx

    @torch.no_grad()
    def refine(self, net: PointRendNet, feats, rois, labels):
        """The detected classes' logits of rois (B, D, 4) after every
        subdivision step, (B * D, 56, 56), and the refined cells of each
        step."""
        coarse = self.coarse_logits(net, feats, rois)
        labels = labels.reshape(-1)
        logits, cells = pick_class(coarse, labels), []
        for _ in range(self.subdivision_steps):
            logits, idx = self.subdivide(net, feats[0], rois, coarse, logits,
                                         labels)
            cells.append(idx)
        return logits, cells

    @torch.no_grad()
    def mask_predict(self, net: PointRendNet, feats, res: DetResults, meta,
                     rescale=True):
        """(B, D, 56, 56) mask probabilities of the detections."""
        rois = self.mask_rois(res, meta, rescale)
        logits, _ = self.refine(net, feats, rois, res.labels)
        return torch.sigmoid(logits).reshape(*rois.shape[:2],
                                             *logits.shape[1:])

    def train_draws(self, img_id, b, n_anchors, n_candidates, device):
        """Faster R-CNN's four sampler draws, then the point draws: (B * S,
        588, 2) and (B * S, 49, 2) uniform in [0, 1), S = the sampled RoIs
        an image."""
        draws = super().train_draws(img_id, b, n_anchors, n_candidates,
                                    device)
        gen = torch.Generator(device=device).manual_seed(
            int(img_id.sum()) + 99)
        r = b * self.rcnn_train_cfg.num_samples
        return draws + tuple(
            torch.rand((r, n, 2), generator=gen, device=device)
            for n in (NUM_POINTS * OVERSAMPLE, NUM_POINTS - IMPORTANT))

    def rcnn_losses(self, net, feats, samples: RoISamples, gt, draws=None):
        """Faster R-CNN's R-CNN losses, then ``loss_mask`` (coarse) and
        ``loss_point`` on the sampled RoIs; ``draws[4:6]`` the two uniform
        point draws (``train_draws``)."""
        if draws is None or len(draws) != 6:
            raise ValueError('PointRend: draws must hold the four sampler '
                             'draws and the two point draws (train_draws)')
        rnd, rnd2 = draws[4], draws[5]
        # the coarse and point losses take the place of Mask R-CNN's
        losses = FasterRCNNDetector.rcnn_losses(self, net, feats, samples,
                                                gt)
        b, s = samples.rois.shape[:2]
        labels = samples.labels.reshape(-1)
        pos = samples.is_pos.reshape(-1).float()
        n_pos = pos.sum().clamp(min=1.0)
        coarse = net.roi_head.mask_head(
            self.mask_feats(feats, samples.rois).flatten(0, 1)).float()
        coarse_at = pick_class(coarse, labels)                  # (R, 14, 14)
        mt14 = self.mask_targets(samples, gt, coarse.shape[-1])
        losses['loss_mask'] = (bce_softplus(coarse_at, mt14).mean((1, 2)) *
                               pos).sum() / n_pos

        with torch.no_grad():
            unc = -point_sample(coarse_at[:, None], rnd)[..., 0].abs()
        _, imp = topk_stable(unc, IMPORTANT)
        pts = torch.cat([take_rows(rnd, imp), rnd2], 1)         # (R, K, 2)
        k = pts.shape[1]
        coarse_pts = point_sample(coarse, pts)                  # (R, K, C)
        p2 = feats[0]
        fine = point_sample(p2, fine_points(
            samples.rois, pts.reshape(b, s, k, 2), p2.shape[-2:]))
        plog = net.roi_head.point_head(fine.reshape(b * s, k, -1),
                                       coarse_pts).float()
        pt_at = torch.gather(plog, 2, labels.long().clamp(
            0, plog.shape[-1] - 1)[:, None, None].expand(-1, k, 1))[..., 0]
        with torch.no_grad():
            tgt = (point_sample(mt14[:, None], pts)[..., 0] > 0.5).float()
        losses['loss_point'] = (bce_softplus(pt_at, tgt).mean(-1) *
                                pos).sum() / n_pos
        return losses


def bce_softplus(logits, targets):
    """erd_tpu's PointRend BCE: softplus(-x) * t + softplus(x) * (1 - t),
    softplus as ``jax.nn.softplus`` (logaddexp(x, 0))."""
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return torch.logaddexp(-logits, zero) * targets + \
        torch.logaddexp(logits, zero) * (1 - targets)
