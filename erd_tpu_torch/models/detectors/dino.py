"""DINO-4scale R50 serving and training; the counterpart of
erd_tpu/models/detectors/dino.py.

The backbone, neck and prediction of Deformable DETR
(``deformable_detr.py``) around ``DINOHead``: the deformable encoder,
mixed query selection and the box-refining decoder, with no denoising
queries at inference. ``loss`` adds dn_groups x 2 x MAX_GT contrastive
denoising queries, whose noise comes from a ``torch.Generator`` seeded with
the batch's img_id sum (erd_tpu folds the same sum into its PRNG key; the
two generators give different numbers) or from the caller's ``draws``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from ..heads.deformable_detr_head import normalized_gt
from ..heads.dino_head import (DINOHead, DINOTrainConfig, dino_loss,
                               make_dn_attn_mask, make_dn_queries)
from .deformable_detr import DeformableDETRDetector, DETRNet


@dataclass
class DINODetector(DeformableDETRDetector):
    """Config + functions of DINO serving and training; ``forward_raw``
    returns erd_tpu's dict (all_cls, all_boxes, enc_cls, enc_boxes,
    num_dn)."""
    num_queries: int = 900
    max_per_img: int = 300
    train_cfg: DINOTrainConfig = field(default_factory=DINOTrainConfig)

    def build_net(self) -> DETRNet:
        return DETRNet(DINOHead(
            self.num_classes, num_queries=self.num_queries,
            param_dtype=self.compute_dtype), self.depth,
            frozen_stages=self.frozen_stages)

    def dn_draws(self, img_id, b, num_dn, device):
        """The four draws of ``make_dn_queries`` for (B, D) denoising
        slots, from a ``torch.Generator`` on ``device`` seeded with
        ``img_id.sum()``."""
        gen = torch.Generator(device=device).manual_seed(int(img_id.sum()))
        return (torch.rand((b, num_dn), generator=gen, device=device),
                torch.randint(0, self.num_classes, (b, num_dn),
                              generator=gen, device=device),
                torch.randint(0, 2, (b, num_dn, 4), generator=gen,
                              device=device),
                torch.rand((b, num_dn, 4), generator=gen, device=device))

    def loss(self, net: DETRNet, batch, draws=None,
             matches: Optional[Sequence] = None):
        """Training losses. batch: dict(images (B, H, W, 3) uint8, gt:
        GTInstances, meta: ImageMeta of (B, ...) tensors) on the network's
        device. ``draws``: the four tensors of ``dn_draws`` to use instead
        of its generator's; ``matches``: the (B, Q) assignments of the
        decoder layers and then the encoder, to use instead of the
        Hungarian solver's. The head's outputs are cast to float32 before
        the loss. Returns ``dino_loss``'s dict of 0-dim tensors."""
        images, gt = batch['images'], batch['gt']
        canvas = images.shape[1:3]
        cfg = self.train_cfg
        b, g = gt.labels.shape
        num_dn = 2 * g * cfg.dn_groups
        if draws is None:
            draws = self.dn_draws(batch['meta'].img_id, b, num_dn,
                                  images.device)
        dn_labels, dn_boxes, dn_valid = make_dn_queries(
            normalized_gt(gt, canvas)[1], gt.labels, gt.mask,
            self.num_classes, draws, cfg.dn_groups, cfg.label_noise_scale,
            cfg.box_noise_scale)
        mask = make_dn_attn_mask(num_dn, self.num_queries, cfg.dn_groups,
                                 images.device)
        outs = net(self.preprocessor(images), dn_labels, dn_boxes, mask)
        outs = {k: v.float() if torch.is_tensor(v) else v
                for k, v in outs.items()}
        return dino_loss(outs, gt, canvas, self.num_classes, cfg,
                         dn_valid=dn_valid, matches=matches)
