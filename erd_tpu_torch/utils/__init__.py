"""Small helpers shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the port '
                'on the CPU')
        return torch.device('cuda')
    return torch.device(device)
