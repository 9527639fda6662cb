"""SGD with frozen stages; the counterpart of erd_tpu/engine/optim.py.

torch.optim.SGD updates in the reference's order, which erd_tpu builds from
optax: ``g += wd * w; buf = mu * buf + g; w -= lr * buf``. The model owns
which stages are frozen: ``ResNet(frozen_stages=...)`` gives the stem and
stages ``requires_grad=False``, and the optimizer takes only the parameters
that still require a gradient, which gives the trajectory of erd_tpu's
zero-update mask (``set_to_zero``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def resnet_frozen_paths(frozen_stages: int = 1) -> Tuple[str, ...]:
    """Parameter-name prefixes frozen by ``frozen_stages`` (the stem for
    >= 0, and layer1..layer``frozen_stages``)."""
    prefixes = []
    if frozen_stages >= 0:
        prefixes += ['backbone.conv1.', 'backbone.bn1.']
    prefixes += [f'backbone.layer{s}.' for s in range(1, frozen_stages + 1)]
    return tuple(prefixes)


def sgd_optimizer(net: nn.Module, lr: float, momentum: float = 0.9,
                  weight_decay: float = 1e-4) -> torch.optim.SGD:
    """SGD over the parameters of ``net`` that require a gradient. The
    caller sets each group's ``lr`` from the schedule before every step."""
    params = [p for p in net.parameters() if p.requires_grad]
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay)
