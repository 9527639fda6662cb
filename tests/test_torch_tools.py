"""The port's diagnostic tools on the CPU: fault 3.10's bisect
(erd_tpu_torch/tools/bisect_fp32_conv.py) compares float32 conv routes on
the card; here each route is held against F.conv2d in float64, where every
route must give the same values up to the order of its sums (1e-12 of
max|ref|)."""
import importlib

import pytest
import torch
import torch.nn.functional as F

from erd_tpu_torch.tools import bisect_fp32_conv as bisect

torch.set_num_threads(2)


def _close(got, want):
    return float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize('k', [1, 3])
def test_direct_conv_matches_conv2d_forward_and_backward(k):
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(3, 6, 7, 9, dtype=torch.float64, generator=gen)
    w = torch.randn(5, 6, k, k, dtype=torch.float64, generator=gen)
    r = torch.randn(3, 5, 7, 9, dtype=torch.float64, generator=gen)
    pad = (k // 2,) * 2
    outs = []
    for conv in (lambda a, b: bisect.direct_conv(a, b, pad),
                 lambda a, b: F.conv2d(a, b, None, 1, pad)):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = conv(a, b)
        outs.append([out.detach()] + list(torch.autograd.grad(out, [a, b],
                                                              r)))
    assert all(_close(g, e) for g, e in zip(*outs))


@pytest.mark.parametrize('route', bisect.ROUTES)
def test_conv_chain_routes_agree_in_float64(route):
    """Every route of the bisect on a layer3-like chain (1x1, 3x3, 1x1),
    forward and both gradients, against the port's conv2d_ieee; the
    direct_3x3 stand-in leaves CPU tensors on the original route."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 16, 6, 8, dtype=torch.float64, generator=gen)
    ws = [torch.randn(s, dtype=torch.float64, generator=gen) for s in
          ((8, 16, 1, 1), (8, 8, 3, 3), (16, 8, 1, 1))]

    def run(route):
        a = x.clone().requires_grad_(True)
        bs = [w.clone().requires_grad_(True) for w in ws]
        out = bisect.conv_chain(a, bs, route)
        return [out.detach()] + list(torch.autograd.grad(
            out.square().sum(), [a] + bs))
    want = run('cudnn')
    utils = importlib.import_module('erd_tpu_torch.utils')
    original = utils._IEEEConv2d
    utils._IEEEConv2d = bisect.direct_3x3(original)
    try:
        got = run(route)
    finally:
        utils._IEEEConv2d = original
    assert all(_close(g, e) for g, e in zip(got, want))
