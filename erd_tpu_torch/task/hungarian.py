"""Hungarian (optimal bipartite) assignment for the set-prediction heads;
the counterpart of erd_tpu/task/hungarian.py.

The (B, Q, G) cost goes to the host once per call, detached, and scipy's
``linear_sum_assignment`` (Jonker-Volgenant) solves each image, as erd_tpu's
``pure_callback`` does. Padded gt columns carry the cost ``BIG``, and a
query assigned into one stays unmatched.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e6


def _solve_host(cost: np.ndarray) -> np.ndarray:
    """(B, Q, G) -> (B, Q) assigned gt index or -1 (a copy of erd_tpu's)."""
    from scipy.optimize import linear_sum_assignment
    cost = np.asarray(cost)
    b, q, g = cost.shape
    out = np.full((b, q), -1, np.int32)
    for i in range(b):
        rows, cols = linear_sum_assignment(cost[i])
        for r, c in zip(rows, cols):
            if cost[i, r, c] < BIG / 2:  # ignore padded-gt columns
                out[i, r] = c
    return out


def hungarian_match(cost, gt_mask):
    """cost (B, Q, G); gt_mask (B, G) bool -> (B, Q) int64 gt index or -1,
    on the cost's device. No gradient flows through the assignment."""
    cost = torch.where(gt_mask[:, None, :], cost.detach(),
                       torch.full((), BIG, dtype=cost.dtype,
                                  device=cost.device))
    out = _solve_host(cost.float().cpu().numpy())
    return torch.from_numpy(out).to(device=cost.device, dtype=torch.int64)
