"""DINO head: mixed query selection, a box-refining decoder, contrastive
denoising (CDN) queries and the set loss; the counterpart of
erd_tpu/models/heads/dino_head.py.

The encoder is Deformable DETR's. From its memory, per-token proposals (the
cell centres with size 0.05 * 2^level) are refined by the encoder
regression MLP, and the ``num_queries`` tokens of largest max class logit
become the decoder's initial reference boxes (ties lowest token first, as
``lax.top_k``); the content queries stay learned. Each decoder layer
embeds its reference boxes (sine embedding + ``ref_pos`` MLP), samples
around them (``box=True``), and refines them in inverse-sigmoid space; the
outputs are taken before the refinement is detached. The selected boxes
enter the decoder detached (erd_tpu's ``stop_gradient(init_ref)``): only
the encoder's auxiliary loss trains the encoder's box regression through
them.

Training prepends D = 2 * G * dn_groups denoising queries (``dn_label_embed``
of noised gt labels, at noised gt boxes; ``make_dn_queries`` takes its
random draws as arguments) behind the ``make_dn_attn_mask`` attention mask;
serving passes none. ``dino_loss`` is erd_tpu's: per decoder layer the
Hungarian set loss of the matching queries and the known-assignment loss of
the denoising queries, and the encoder's auxiliary set loss.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...losses import giou_loss, sigmoid_focal_loss
from ...ops.misc import take_rows, topk_stable
from ...structures import cxcywh_to_xyxy
from ..layers import LayerNorm, Linear
from .deformable_detr_head import (DeformableDecoderLayer,
                                   DeformableEncoderHead, Shapes,
                                   match_layer, matched_losses,
                                   normalized_gt)


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def sine_embed_boxes(boxes, num_feats: int = 128,
                     temperature: float = 10000.0):
    """(..., 4) normalized cxcywh -> (..., 3 * num_feats): the sine
    embeddings of cy and cx (num_feats each) and of w and h (num_feats / 2
    each), in that order (erd_tpu's DAB / DINO form)."""
    def embed(v, n):
        dt = temperature ** (2 * torch.div(
            torch.arange(n, device=v.device), 2, rounding_mode='floor')
            / torch.full((), float(n), device=v.device))
        pos = v[..., None] * 2 * math.pi / dt
        return torch.cat([torch.sin(pos[..., 0::2]),
                          torch.cos(pos[..., 1::2])], -1)

    half = num_feats // 2
    return torch.cat([embed(boxes[..., 1], num_feats),
                      embed(boxes[..., 0], num_feats),
                      embed(boxes[..., 2], half),
                      embed(boxes[..., 3], half)], -1)


class DINOHead(DeformableEncoderHead):
    """erd_tpu's ``DINOHeadNet``: ``encode``, ``proposals``, ``select``
    (top-``num_queries``) and ``decode``, with optional denoising
    queries."""

    def __init__(self, num_classes: int, embed_dim: int = 256,
                 num_queries: int = 900, num_levels: int = 4,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(embed_dim, num_levels, num_encoder_layers,
                         param_dtype)
        c = embed_dim
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.enc_output = Linear(c, c, param_dtype)
        self.enc_output_norm = LayerNorm(c, param_dtype=param_dtype)
        self.enc_cls = Linear(c, num_classes, param_dtype)
        self.enc_reg_fc0 = Linear(c, c, param_dtype)
        self.enc_reg_fc1 = Linear(c, c, param_dtype)
        self.enc_reg = Linear(c, 4, param_dtype)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, c))
        self.dn_label_embed = nn.Embedding(num_classes, c)
        self.fc_cls = Linear(c, num_classes, param_dtype)
        self.reg_fc0 = Linear(c, c, param_dtype)
        self.reg_fc1 = Linear(c, c, param_dtype)
        self.fc_reg = Linear(c, 4, param_dtype)
        # the sine embedding of (cy, cx, w, h) has 3 * c / 2 features
        self.ref_pos_fc0 = Linear(3 * c // 2, c, param_dtype)
        self.ref_pos_fc1 = Linear(c, c, param_dtype)
        for i in range(num_decoder_layers):
            self.add_module(f'decoder_{i}', DeformableDecoderLayer(
                c, ffn_dim=2048, box=True, param_dtype=param_dtype))

    def init_extra(self):
        """erd_tpu's zero init of the decoder's last regression layer."""
        self.fc_reg.weight.zero_()

    def proposals(self, memory, shapes: Shapes):
        """The encoder's per-token outputs: (class logits (B, N_tok,
        classes), boxes (B, N_tok, 4) normalized cxcywh)."""
        props = self.grids(shapes, memory.device)[1]
        mem = self.enc_output_norm(self.enc_output(memory))
        delta = self.enc_reg(F.relu(self.enc_reg_fc1(F.relu(
            self.enc_reg_fc0(mem)))))
        return self.enc_cls(mem), torch.sigmoid(delta + inverse_sigmoid(props))

    def select(self, enc_cls):
        """Mixed query selection: the (B, k) tokens of largest max class
        logit, k = min(num_queries, N_tok)."""
        k = min(self.num_queries, enc_cls.shape[1])
        return topk_stable(enc_cls.amax(-1), k)[1]

    def decode(self, memory, shapes: Shapes, top_idx, init_ref,
               dn_labels=None, dn_boxes=None, dn_attn_mask=None):
        """-> (all_cls (layers, B, T, classes), all_boxes (layers, B, T, 4)
        normalized cxcywh) from the selected tokens ``top_idx`` and their
        boxes ``init_ref``; T = D + k with D denoising queries (``dn_labels``
        (B, D), ``dn_boxes`` (B, D, 4)) ahead of the k matching ones, under
        ``dn_attn_mask``'s leading (T, T) block (True = may attend)."""
        b, k = top_idx.shape
        c = self.embed_dim
        query = self.query_embed.to(self.param_dtype)[None, :k].expand(
            b, k, c)
        ref = init_ref
        if dn_labels is not None:
            label_embed = self.dn_label_embed.weight.to(
                self.param_dtype)[dn_labels.long()]
            query = torch.cat([label_embed, query], 1)
            ref = torch.cat([dn_boxes, init_ref], 1)
        mask = None
        if dn_attn_mask is not None:
            # the mask is built for D + num_queries slots; the matching
            # count is capped at the token count, and the matching block is
            # homogeneous, so the capped mask is the leading slice
            t = query.shape[1]
            mask = dn_attn_mask[:t, :t][None, None]
        all_cls, all_boxes = [], []
        for i in range(self.num_decoder_layers):
            qp = self.ref_pos_fc1(F.relu(self.ref_pos_fc0(
                sine_embed_boxes(ref, c // 2))))
            query = getattr(self, f'decoder_{i}')(query, qp, memory, shapes,
                                                  ref, mask)
            delta = self.fc_reg(F.relu(self.reg_fc1(F.relu(
                self.reg_fc0(query)))))
            new_ref = torch.sigmoid(delta + inverse_sigmoid(ref))
            all_cls.append(self.fc_cls(query))
            all_boxes.append(new_ref)  # look forward twice: pre-detach
            ref = new_ref.detach()
        return torch.stack(all_cls), torch.stack(all_boxes)

    def forward(self, feats, dn_labels=None, dn_boxes=None,
                dn_attn_mask=None):
        memory, shapes = self.encode(feats)
        enc_cls, enc_boxes = self.proposals(memory, shapes)
        top_idx = self.select(enc_cls)
        enc_boxes = take_rows(enc_boxes, top_idx)
        # the decoder starts from the detached boxes (erd_tpu's
        # stop_gradient); enc_boxes keep their gradient for the encoder loss
        all_cls, all_boxes = self.decode(memory, shapes, top_idx,
                                         enc_boxes.detach(), dn_labels,
                                         dn_boxes, dn_attn_mask)
        return dict(all_cls=all_cls, all_boxes=all_boxes,
                    enc_cls=take_rows(enc_cls, top_idx), enc_boxes=enc_boxes,
                    num_dn=0 if dn_labels is None else dn_labels.shape[1])


def make_dn_queries(gt_boxes_n, gt_labels, gt_mask, num_classes, draws,
                    dn_groups=3, label_noise_scale=0.5, box_noise_scale=1.0):
    """gt boxes (B, G, 4) normalized cxcywh -> dn labels (B, D) int64, boxes
    (B, D, 4) and valid (B, D), D = 2 * G * dn_groups (erd_tpu's static
    layout: per group G positive then G negative slots).

    ``draws`` = (flip (B, D) uniform, labels (B, D) ints in [0,
    num_classes), signs (B, D, 4) ints in {0, 1}, parts (B, D, 4) uniform):
    a label is replaced where flip < label_noise_scale / 2; each box
    coordinate moves by sign * part * (w/2, h/2, w, h) * box_noise_scale /
    2, with part + 1 in the negative slots; the result is clipped to [0, 1]
    (w and h to [1e-4, 1])."""
    flip, rand_lab, sign, part = draws
    b, g = gt_labels.shape
    d = 2 * g * dn_groups
    labels = gt_labels.long().repeat(1, 2 * dn_groups)
    labels = torch.where(flip < label_noise_scale * 0.5, rand_lab.long(),
                         labels)
    boxes = gt_boxes_n.repeat(1, 2 * dn_groups, 1)
    wh = boxes[..., 2:]
    diff = torch.cat([wh / 2, wh], -1)
    sign = sign.to(torch.int32) * 2 - 1
    is_neg = (torch.arange(d, device=boxes.device) % (2 * g)) >= g
    part = part + is_neg[None, :, None]
    noised = boxes + sign * part * diff * box_noise_scale * 0.5
    noised = noised.clamp(0.0, 1.0)
    noised = torch.cat([noised[..., :2], noised[..., 2:].clamp(1e-4, 1.0)],
                       -1)
    return labels, noised, gt_mask.repeat(1, 2 * dn_groups)


def make_dn_attn_mask(num_dn, num_matching, dn_groups, device=None):
    """(T, T) bool attention mask, T = num_dn + num_matching (True = may
    attend): matching queries never see dn queries; dn groups never see
    each other."""
    t = num_dn + num_matching
    mask = np.ones((t, t), bool)
    mask[num_dn:, :num_dn] = False
    gsz = num_dn // max(dn_groups, 1)
    for i in range(dn_groups):
        a, bnd = i * gsz, (i + 1) * gsz
        mask[a:bnd, :a] = False
        mask[a:bnd, bnd:num_dn] = False
    return torch.from_numpy(mask).to(device)


@dataclass(frozen=True)
class DINOTrainConfig:
    cls_cost: float = 2.0
    l1_cost: float = 5.0
    giou_cost: float = 2.0
    cls_loss_weight: float = 1.0
    l1_loss_weight: float = 5.0
    giou_loss_weight: float = 2.0
    dn_groups: int = 3
    label_noise_scale: float = 0.5
    box_noise_scale: float = 1.0


def _dn_layer_loss(cls, boxes, gt_xyxy_n, gt_cxcywh_n, gt_labels, dn_valid,
                   num_classes, num_pos, cfg):
    """Known assignment: in each group slot j < G is gt j's positive, slot
    G + j its negative (background); slots of padded gts weigh 0."""
    b, d = cls.shape[:2]
    g = gt_labels.shape[1]
    in_group = torch.arange(d, device=cls.device) % (2 * g)
    is_pos = (in_group < g)[None, :] & dn_valid
    gt_idx = (in_group % g)[None, :].expand(b, d)
    labels = torch.where(is_pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         num_classes)
    denom = (num_pos * cfg.dn_groups).clamp(min=1.0)
    loss_cls = cfg.cls_loss_weight * sigmoid_focal_loss(
        cls.reshape(-1, num_classes), labels.reshape(-1),
        weight=dn_valid.float().reshape(-1), avg_factor=denom)
    l1 = (boxes - take_rows(gt_cxcywh_n, gt_idx)).abs().sum(-1)
    loss_bbox = cfg.l1_loss_weight * (l1 * is_pos).sum() / denom
    lg = giou_loss(cxcywh_to_xyxy(boxes).reshape(-1, 4),
                   take_rows(gt_xyxy_n, gt_idx).reshape(-1, 4),
                   reduction='none')
    loss_giou = cfg.giou_loss_weight * \
        (lg * is_pos.reshape(-1)).sum() / denom
    return loss_cls, loss_bbox, loss_giou


def dino_loss(outs, gt, canvas_hw, num_classes, cfg=DINOTrainConfig(),
              dn_valid=None, matches: Optional[Sequence] = None):
    """The DINO losses of the head's float32 outputs: per decoder layer the
    matching queries' set loss (``loss_cls``, ``loss_bbox``, ``loss_giou``)
    and, with denoising queries, their loss (``loss_dn_*``), ``_aux{i}``
    for all but the last layer; then the encoder's (``loss_enc_*``) on the
    selected tokens. ``matches``: the (B, Q) assignments of the layers and
    then the encoder, to use instead of the Hungarian solver's."""
    gt_xyxy_n, gt_cxcywh_n, num_pos = normalized_gt(gt, canvas_hw)
    n_dn = outs['num_dn']
    n_layers = outs['all_cls'].shape[0]

    def given(i):
        return None if matches is None else matches[i]

    def matching(cls, boxes, i):
        match = match_layer(cls, boxes, gt_xyxy_n, gt_cxcywh_n, gt, cfg,
                            given(i))
        return matched_losses(cls, boxes, match, gt_xyxy_n, gt_cxcywh_n,
                              gt.labels, num_classes, num_pos, cfg)

    losses = {}
    for lyr in range(n_layers):
        cls, boxes = outs['all_cls'][lyr], outs['all_boxes'][lyr]
        sfx = '' if lyr == n_layers - 1 else f'_aux{lyr}'
        for name, v in zip(('cls', 'bbox', 'giou'), matching(
                cls[:, n_dn:], boxes[:, n_dn:], lyr)):
            losses[f'loss_{name}{sfx}'] = v
        if n_dn:
            for name, v in zip(('cls', 'bbox', 'giou'), _dn_layer_loss(
                    cls[:, :n_dn], boxes[:, :n_dn], gt_xyxy_n, gt_cxcywh_n,
                    gt.labels, dn_valid, num_classes, num_pos, cfg)):
                losses[f'loss_dn_{name}{sfx}'] = v
    for name, v in zip(('cls', 'bbox', 'giou'), matching(
            outs['enc_cls'], outs['enc_boxes'], n_layers)):
        losses[f'loss_enc_{name}'] = v
    return losses
