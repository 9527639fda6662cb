"""Deformable DETR head: deformable encoder and decoder, and its set loss;
the counterpart of erd_tpu/models/heads/deformable_detr_head.py.

erd_tpu's DETR family, not mmdet's: no padding mask and no valid ratios,
level embeddings only in the encoder (no sine positional encoding), one
``fc_cls`` shared by all decoder layers, and ``sampling_offsets`` /
``attention_weights`` initialised to zero. Module and parameter names are
erd_tpu's scopes (``encoder_0.self_attn.value_proj``, ``level_embed_0``).

Maps come in NCHW and are flattened level by level into (B, N_tok, C)
tokens in row-major (H, W) order, erd_tpu's token order. The sampling runs
through ``ops.ms_deform_attn`` (the CUDA kernel on the card). Every dense
layer rounds its weights to the compute dtype (``param_dtype``) and runs in
the promoted dtype of its input, as erd_tpu's ``cast_compute_params`` with
flax's promotion does; so in a bf16 model the float32 maps keep the head
in float32, while the bf16 ``query_embed`` puts decoder_0's self-attention,
norm1 and cross-attention projections in bf16.

``deformable_detr_loss`` is erd_tpu's: per decoder layer, a Hungarian
match (``task.hungarian_match``, on the host) of a focal class cost and the
L1 and GIoU box costs, then the sigmoid focal loss and the L1 and GIoU
losses of the matched queries (``_aux{i}`` for all but the last layer).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...losses import giou_loss, sigmoid_focal_loss
from ...ops import ms_deform_attn
from ...ops.misc import take_rows
from ...structures import bbox_overlaps, cxcywh_to_xyxy, xyxy_to_cxcywh
from ...task import hungarian_match
from ..layers import LayerNorm, Linear, MultiheadAttention, softmax

Shapes = List[Tuple[int, int]]
ARRANGE_STD = 0.02  # std of arrange_sampling's seeded kernels


class MSDeformAttn(nn.Module):
    """One deformable attention block: erd_tpu's ``MSDeformAttnLayer``
    (``box=False``: loc = ref + offset / (W_l, H_l)) or ``BoxMSDeformAttn``
    (``box=True``: loc = ref centre + offset / K * ref wh * 0.5)."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4, box: bool = False,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.box = num_points, box
        n = num_heads * num_levels * num_points
        self.sampling_offsets = Linear(embed_dim, 2 * n, param_dtype)
        self.attention_weights = Linear(embed_dim, n, param_dtype)
        self.value_proj = Linear(embed_dim, embed_dim, param_dtype)
        self.output_proj = Linear(embed_dim, embed_dim, param_dtype)

    def forward(self, query, value_tokens, shapes: Shapes, ref):
        """query (B, Q, C); value_tokens (B, N_tok, C); ref (B, Q, 2)
        normalized points, or (B, Q, 4) cxcywh boxes with ``box``."""
        b, q, c = query.shape
        heads, lv, k = self.num_heads, self.num_levels, self.num_points
        off = self.sampling_offsets(query).reshape(b, q, heads, lv, k, 2)
        attn = softmax(self.attention_weights(query).reshape(
            b, q, heads, lv * k)).reshape(b, q, heads, lv, k)
        values = self.value_proj(value_tokens).reshape(
            b, value_tokens.shape[1], heads, c // heads)
        if self.box:
            kk = torch.full((), float(k), device=off.device)
            locs = ref[:, :, None, None, None, :2] + \
                off / kk * ref[:, :, None, None, None, 2:] * 0.5
        else:
            wh = torch.tensor([[w, h] for h, w in shapes],
                              dtype=torch.float32, device=off.device)
            locs = ref[:, :, None, None, None, :] + off / wh[:, None, :]
        out = ms_deform_attn(values.contiguous(), shapes, locs.contiguous(),
                             attn.contiguous())
        return self.output_proj(out.reshape(b, q, c))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int = 256, ffn_dim: int = 1024,
                 num_levels: int = 4,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MSDeformAttn(embed_dim, num_levels=num_levels,
                                      param_dtype=param_dtype)
        self.norm1 = LayerNorm(embed_dim, param_dtype=param_dtype)
        self.ffn1 = Linear(embed_dim, ffn_dim, param_dtype)
        self.ffn2 = Linear(ffn_dim, embed_dim, param_dtype)
        self.norm2 = LayerNorm(embed_dim, param_dtype=param_dtype)

    def forward(self, tokens, shapes: Shapes, refs, pos):
        x = self.norm1(tokens + self.self_attn(tokens + pos, tokens, shapes,
                                               refs))
        return self.norm2(x + self.ffn2(F.relu(self.ffn1(x))))


class DeformableDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention, FFN; erd_tpu's
    ``DeformableDecoderLayer`` (FFN 1024) and, with ``box=True`` and FFN
    2048, ``DINODecoderLayer``."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 ffn_dim: int = 1024, box: bool = False,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dim, num_heads, param_dtype)
        self.norm1 = LayerNorm(embed_dim, param_dtype=param_dtype)
        self.cross_attn = MSDeformAttn(embed_dim, num_heads, box=box,
                                       param_dtype=param_dtype)
        self.norm2 = LayerNorm(embed_dim, param_dtype=param_dtype)
        self.ffn1 = Linear(embed_dim, ffn_dim, param_dtype)
        self.ffn2 = Linear(ffn_dim, embed_dim, param_dtype)
        self.norm3 = LayerNorm(embed_dim, param_dtype=param_dtype)

    def forward(self, query, query_pos, memory, shapes: Shapes, ref,
                self_attn_mask=None):
        q = query + query_pos
        x = self.norm1(query + self.self_attn(q, q, query, self_attn_mask))
        x = self.norm2(x + self.cross_attn(x + query_pos, memory, shapes,
                                           ref))
        return self.norm3(x + self.ffn2(F.relu(self.ffn1(x))))


def level_grids(shapes: Shapes) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token reference points (N_tok, 2), the cell centres
    ((i + 0.5) / size, float32 IEEE division as erd_tpu's), and DINO's
    encoder proposals (N_tok, 4): the centres with size 0.05 * 2^level."""
    refs, props = [], []
    for lvl, (h, w) in enumerate(shapes):
        ys = (np.arange(h, dtype=np.float32) + np.float32(0.5)) / \
            np.float32(h)
        xs = (np.arange(w, dtype=np.float32) + np.float32(0.5)) / \
            np.float32(w)
        gx, gy = np.meshgrid(xs, ys)
        ctr = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        refs.append(ctr)
        props.append(np.concatenate(
            [ctr, np.full((len(ctr), 2), 0.05 * 2.0 ** lvl, np.float32)],
            -1))
    return np.concatenate(refs), np.concatenate(props)


class DeformableEncoderHead(nn.Module):
    """The level embeddings and deformable encoder that Deformable DETR and
    DINO share."""

    def __init__(self, embed_dim: int = 256, num_levels: int = 4,
                 num_encoder_layers: int = 6,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_levels = embed_dim, num_levels
        self.param_dtype = param_dtype
        self.num_encoder_layers = num_encoder_layers
        for lvl in range(num_levels):
            self.register_parameter(f'level_embed_{lvl}',
                                    nn.Parameter(torch.zeros(embed_dim)))
        for i in range(num_encoder_layers):
            self.add_module(f'encoder_{i}', DeformableEncoderLayer(
                embed_dim, num_levels=num_levels, param_dtype=param_dtype))
        self._grids: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def init_extra(self):
        """The head's own init after ``DETRNet.init_weights``; none here."""

    def grids(self, shapes: Shapes, device):
        """``level_grids`` as tensors on ``device``, cached per shapes."""
        key = (tuple(shapes), str(device))
        if key not in self._grids:
            self._grids[key] = tuple(torch.from_numpy(a).to(device)
                                     for a in level_grids(shapes))
        return self._grids[key]

    def encode(self, feats: Sequence[torch.Tensor]):
        """feats: per-level (B, C, H_l, W_l) float32 maps -> (memory (B,
        N_tok, C), the levels' (H, W))."""
        if len(feats) != self.num_levels:
            raise ValueError(f'the head takes {self.num_levels} levels, got '
                             f'{len(feats)}')
        shapes = [tuple(int(s) for s in f.shape[-2:]) for f in feats]
        b, c = feats[0].shape[:2]
        tokens = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], 1)
        refs = self.grids(shapes, tokens.device)[0][None].expand(b, -1, -1)
        pos = torch.cat([
            getattr(self, f'level_embed_{lvl}').to(self.param_dtype).expand(
                h * w, c) for lvl, (h, w) in enumerate(shapes)])
        for i in range(self.num_encoder_layers):
            tokens = getattr(self, f'encoder_{i}')(tokens, shapes, refs, pos)
        return tokens, shapes


class DeformableDETRHead(DeformableEncoderHead):
    """erd_tpu's ``DeformableDETRHeadNet``: learned queries split into
    position and content halves, reference points sigmoid(Linear(pos)),
    boxes (sigmoid(delta_xy + logit(ref)), sigmoid(delta_wh))."""

    def __init__(self, num_classes: int, embed_dim: int = 256,
                 num_queries: int = 300, num_levels: int = 4,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(embed_dim, num_levels, num_encoder_layers,
                         param_dtype)
        c = embed_dim
        self.num_decoder_layers = num_decoder_layers
        self.query_embed = nn.Parameter(torch.zeros(num_queries, 2 * c))
        self.reference_points = Linear(c, 2, param_dtype)
        self.fc_cls = Linear(c, num_classes, param_dtype)
        self.reg_fc0 = Linear(c, c, param_dtype)
        self.reg_fc1 = Linear(c, c, param_dtype)
        self.fc_reg = Linear(c, 4, param_dtype)
        for i in range(num_decoder_layers):
            self.add_module(f'decoder_{i}', DeformableDecoderLayer(
                c, param_dtype=param_dtype))

    def decode(self, memory, shapes: Shapes):
        """-> (all_cls (layers, B, Q, classes), all_boxes (layers, B, Q,
        4) normalized cxcywh)."""
        b, c = memory.shape[0], self.embed_dim
        qe = self.query_embed.to(self.param_dtype)
        query_pos = qe[None, :, :c].expand(b, -1, -1)
        query = qe[None, :, c:].expand(b, -1, -1)
        ref = torch.sigmoid(self.reference_points(query_pos))
        lo, hi = 1e-6, 1 - 1e-6
        ref_logit = torch.log(ref.clamp(lo, hi) / (1 - ref).clamp(lo, hi))
        all_cls, all_boxes = [], []
        for i in range(self.num_decoder_layers):
            query = getattr(self, f'decoder_{i}')(query, query_pos, memory,
                                                  shapes, ref)
            all_cls.append(self.fc_cls(query))
            delta = self.fc_reg(F.relu(self.reg_fc1(F.relu(
                self.reg_fc0(query)))))
            all_boxes.append(torch.cat([
                torch.sigmoid(delta[..., :2] + ref_logit),
                torch.sigmoid(delta[..., 2:])], -1))
        return torch.stack(all_cls), torch.stack(all_boxes)

    def forward(self, feats):
        return self.decode(*self.encode(feats))


def deform_attn_modules(net: nn.Module) -> List[MSDeformAttn]:
    return [m for m in net.modules() if isinstance(m, MSDeformAttn)]


def arrange_sampling(net: nn.Module, seed: int) -> None:
    """Seeded non-zero sampling weights, for checks: erd_tpu initialises
    ``sampling_offsets`` and ``attention_weights`` to zero, which puts every
    sample on a cell centre (bilinear weights 0 or 1, no corner off the
    map) with uniform attention. In module order, each block gets mmcv's
    grid init as its offset bias (head h points along (cos 2 pi h / H,
    sin 2 pi h / H), scaled to max-abs 1, times point + 1), and both
    kernels N(0, ARRANGE_STD^2) from ``np.random.RandomState(seed)``; the
    weight bias stays 0."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in deform_attn_modules(net):
            heads, lv, k = m.num_heads, m.num_levels, m.num_points
            theta = np.arange(heads) * (2.0 * math.pi / heads)
            grid = np.stack([np.cos(theta), np.sin(theta)], -1)
            grid = grid / np.abs(grid).max(-1, keepdims=True)
            grid = grid[:, None, None, :] * np.arange(1, k + 1)[:, None]
            grid = np.broadcast_to(grid, (heads, lv, k, 2))
            for lin, bias in ((m.sampling_offsets, grid.reshape(-1)),
                              (m.attention_weights, None)):
                w = rs.normal(0.0, ARRANGE_STD, tuple(lin.weight.shape))
                lin.weight.copy_(torch.from_numpy(w.astype(np.float32)))
                lin.bias.copy_(torch.zeros_like(lin.bias) if bias is None
                               else torch.from_numpy(bias.astype(np.float32)))


@dataclass(frozen=True)
class DeformableDETRTrainConfig:
    cls_cost: float = 2.0
    l1_cost: float = 5.0
    giou_cost: float = 2.0
    cls_loss_weight: float = 2.0
    l1_loss_weight: float = 5.0
    giou_loss_weight: float = 2.0


def normalized_gt(gt, canvas_hw):
    """(xyxy, cxcywh) gt boxes divided by the canvas, and the positive
    count max(#gt, 1) of the batch."""
    ch, cw = canvas_hw
    norm = torch.tensor([cw, ch, cw, ch], dtype=torch.float32,
                        device=gt.bboxes.device)
    xyxy = gt.bboxes / norm
    return xyxy, xyxy_to_cxcywh(xyxy), gt.mask.sum().float().clamp(min=1.0)


@torch.no_grad()
def match_cost(cls, boxes, gt_xyxy_n, gt_cxcywh_n, gt_labels, cfg):
    """(B, Q, G) matching cost: the focal class cost (mmdet's
    FocalLossCost, alpha 0.25, gamma 2) at each gt's label, the L1 distance
    of the cxcywh boxes and -GIoU, weighted by ``cfg``."""
    prob = torch.sigmoid(cls)
    alpha, gamma = 0.25, 2.0
    pos_cost = alpha * torch.pow(1 - prob, gamma) * \
        (-torch.log(prob.clamp(min=1e-8)))
    neg_cost = (1 - alpha) * torch.pow(prob, gamma) * \
        (-torch.log((1 - prob).clamp(min=1e-8)))
    q = boxes.shape[1]
    cost_cls = torch.gather(pos_cost - neg_cost, 2,
                            gt_labels.long()[:, None, :].expand(-1, q, -1))
    cost_l1 = (boxes[:, :, None, :] - gt_cxcywh_n[:, None, :, :]).abs().sum(-1)
    giou = bbox_overlaps(cxcywh_to_xyxy(boxes), gt_xyxy_n, mode='giou')
    return cfg.cls_cost * cost_cls + cfg.l1_cost * cost_l1 + \
        cfg.giou_cost * (-giou)


def matched_losses(cls, boxes, match, gt_xyxy_n, gt_cxcywh_n, gt_labels,
                   num_classes, num_pos, cfg):
    """(focal, L1, GIoU) losses of one layer's queries under ``match`` (B,
    Q) gt index or -1: unmatched queries are background and carry no box
    loss."""
    matched = match >= 0
    safe = match.clamp(min=0)
    labels = torch.where(matched, torch.gather(gt_labels.long(), 1, safe),
                         num_classes)
    loss_cls = cfg.cls_loss_weight * sigmoid_focal_loss(
        cls.reshape(-1, num_classes), labels.reshape(-1),
        avg_factor=num_pos)
    l1 = (boxes - take_rows(gt_cxcywh_n, safe)).abs().sum(-1)
    loss_bbox = cfg.l1_loss_weight * (l1 * matched).sum() / num_pos
    lg = giou_loss(cxcywh_to_xyxy(boxes).reshape(-1, 4),
                   take_rows(gt_xyxy_n, safe).reshape(-1, 4),
                   reduction='none')
    loss_giou = cfg.giou_loss_weight * \
        (lg * matched.reshape(-1)).sum() / num_pos
    return loss_cls, loss_bbox, loss_giou


def match_layer(cls, boxes, gt_xyxy_n, gt_cxcywh_n, gt, cfg, given=None):
    """One Hungarian match of a layer's outputs, or ``given`` (B, Q) from
    the caller."""
    if given is not None:
        return given.to(device=cls.device, dtype=torch.int64)
    return hungarian_match(match_cost(cls, boxes, gt_xyxy_n, gt_cxcywh_n,
                                      gt.labels, cfg), gt.mask)


def deformable_detr_loss(all_cls, all_boxes, gt, canvas_hw, num_classes,
                         cfg=DeformableDETRTrainConfig(),
                         matches: Optional[Sequence] = None):
    """Sigmoid-focal set losses with Hungarian matching, per decoder layer.

    all_cls (layers, B, Q, classes) and all_boxes (layers, B, Q, 4)
    float32; gt: GTInstances in canvas pixels. ``matches``: one (B, Q)
    assignment per layer to use instead of the Hungarian solver's.
    Returns dict(loss_cls, loss_bbox, loss_giou and their ``_aux{i}``) of
    0-dim tensors."""
    gt_xyxy_n, gt_cxcywh_n, num_pos = normalized_gt(gt, canvas_hw)
    n_layers = all_cls.shape[0]
    losses = {}
    for lyr in range(n_layers):
        cls, boxes = all_cls[lyr], all_boxes[lyr]
        match = match_layer(cls, boxes, gt_xyxy_n, gt_cxcywh_n, gt, cfg,
                            None if matches is None else matches[lyr])
        lc, lb, lg = matched_losses(cls, boxes, match, gt_xyxy_n,
                                    gt_cxcywh_n, gt.labels, num_classes,
                                    num_pos, cfg)
        sfx = '' if lyr == n_layers - 1 else f'_aux{lyr}'
        losses[f'loss_cls{sfx}'] = lc
        losses[f'loss_bbox{sfx}'] = lb
        losses[f'loss_giou{sfx}'] = lg
    return losses
