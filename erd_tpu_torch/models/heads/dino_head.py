"""DINO head: mixed query selection and a box-refining decoder; the
counterpart of erd_tpu/models/heads/dino_head.py (serving).

The encoder is Deformable DETR's. From its memory, per-token proposals (the
cell centres with size 0.05 * 2^level) are refined by the encoder
regression MLP, and the ``num_queries`` tokens of largest max class logit
become the decoder's initial reference boxes (ties lowest token first, as
``lax.top_k``); the content queries stay learned. Each decoder layer
embeds its reference boxes (sine embedding + ``ref_pos`` MLP), samples
around them (``box=True``), and refines them in inverse-sigmoid space; the
outputs are taken before the refinement is detached. Serving passes no
denoising queries: ``dn_label_embed`` is carried so that weights
round-trip.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.misc import take_rows, topk_stable
from ..layers import LayerNorm, Linear
from .deformable_detr_head import (DeformableDecoderLayer,
                                   DeformableEncoderHead, Shapes)


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
    """erd_tpu's ``DINOHeadNet`` at serving: ``encode``, ``proposals``,
    ``select`` (top-``num_queries``) and ``decode``."""

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

    def decode(self, memory, shapes: Shapes, top_idx, init_ref):
        """-> (all_cls (layers, B, k, classes), all_boxes (layers, B, k, 4)
        normalized cxcywh) from the selected tokens ``top_idx`` and their
        boxes ``init_ref``."""
        b, k = top_idx.shape
        c = self.embed_dim
        query = self.query_embed.to(self.param_dtype)[None, :k].expand(
            b, k, c)
        ref = init_ref
        all_cls, all_boxes = [], []
        for i in range(self.num_decoder_layers):
            qp = self.ref_pos_fc1(F.relu(self.ref_pos_fc0(
                sine_embed_boxes(ref, c // 2))))
            query = getattr(self, f'decoder_{i}')(query, qp, memory, shapes,
                                                  ref)
            delta = self.fc_reg(F.relu(self.reg_fc1(F.relu(
                self.reg_fc0(query)))))
            new_ref = torch.sigmoid(delta + inverse_sigmoid(ref))
            all_cls.append(self.fc_cls(query))
            all_boxes.append(new_ref)  # look forward twice: pre-detach
            ref = new_ref.detach()
        return torch.stack(all_cls), torch.stack(all_boxes)

    def forward(self, feats):
        memory, shapes = self.encode(feats)
        enc_cls, enc_boxes = self.proposals(memory, shapes)
        top_idx = self.select(enc_cls)
        enc_boxes = take_rows(enc_boxes, top_idx)
        all_cls, all_boxes = self.decode(memory, shapes, top_idx, enc_boxes)
        return dict(all_cls=all_cls, all_boxes=all_boxes,
                    enc_cls=take_rows(enc_cls, top_idx), enc_boxes=enc_boxes)
