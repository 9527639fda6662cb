"""Random proposal sampler; the counterpart of erd_tpu/task/samplers.py
``random_sample``, batched over leading dims.

Random choice without replacement is a top-k over uniform keys of the
eligible entries (-inf elsewhere): up to ``num * pos_fraction`` positive
slots, the rest negative, fixed-shape. The keys are arguments, so a caller
can hand in any stream's draws (erd_tpu's threefry in a parity test, a
seeded ``torch.Generator`` in training). ``topk_stable`` gives
``lax.top_k``'s order, lowest index first among equal keys: the slots past
the eligible entries are -inf ties, and which indices fill them depends on
that order. erd_tpu's ``ohem_sample`` is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.misc import NEG_INF, topk_stable


@dataclass
class SampleResult:
    idx: torch.Tensor     # (..., num) int64 indices into the candidates
    is_pos: torch.Tensor  # (..., num) bool: a positive slot
    valid: torch.Tensor   # (..., num) bool: the slot holds a sample


def random_sample(pos_mask, neg_mask, pos_keys, neg_keys, num=512,
                  pos_fraction=0.25) -> SampleResult:
    """pos_mask, neg_mask (..., N) bool; pos_keys, neg_keys (..., N) float32
    uniform draws in [0, 1). Returns the ``min(slots, N)`` top keys of each
    kind, positives first."""
    n = pos_mask.shape[-1]
    n_pos = int(num * pos_fraction)
    n_neg = num - n_pos
    ninf = torch.full_like(pos_keys, NEG_INF)
    pos_top, pos_idx = topk_stable(torch.where(pos_mask, pos_keys, ninf),
                                   min(n_pos, n))
    neg_top, neg_idx = topk_stable(torch.where(neg_mask, neg_keys, ninf),
                                   min(n_neg, n))
    idx = torch.cat([pos_idx, neg_idx], -1)
    is_pos = torch.cat([torch.ones_like(pos_idx, dtype=torch.bool),
                        torch.zeros_like(neg_idx, dtype=torch.bool)], -1)
    valid = torch.cat([pos_top > NEG_INF, neg_top > NEG_INF], -1)
    return SampleResult(idx=idx, is_pos=is_pos, valid=valid)
