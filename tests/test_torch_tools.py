"""The port's diagnostic tools on the CPU: fault 3.10's bisect
(erd_tpu_torch/tools/bisect_fp32_conv.py) compares float32 conv routes on
the card; here each route is held against F.conv2d in float64, where every
route must give the same values up to the order of its sums (1e-12 of
max|ref|). The smoke's phase timer (time_smoke_phases.py) on a script of
two phases."""
import importlib
import json

import pytest
import torch
import torch.nn.functional as F

from erd_tpu_torch.tools import bisect_fp32_conv as bisect
from erd_tpu_torch.tools import time_smoke_phases

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


@pytest.mark.parametrize('group,convs', [(('b',), 2), (('b.1',), 1),
                                         (('a',), 1), (('c',), 0)])
def test_no_cudnn_scope_routes_only_the_switched_modules(group, convs):
    """The per-module switch of the bisect's part 2: with the stand-in
    route (here on the CPU), exactly the convs of the tagged modules named
    by the group take it, forward and backward (one count a conv call),
    and every value and gradient is the original route's."""
    from collections import OrderedDict

    from torch import nn

    from erd_tpu_torch.models.layers import Conv2d
    gen = torch.Generator().manual_seed(3)
    torch.manual_seed(3)
    net = bisect.tag_modules(nn.Sequential(OrderedDict(
        a=Conv2d(4, 6, 3), b=nn.Sequential(Conv2d(6, 6, 3),
                                           Conv2d(6, 2, 1)))))
    x = torch.randn(2, 4, 7, 9, generator=gen)

    def run():
        a = x.clone().requires_grad_(True)
        out = net(a)
        return [out.detach()] + list(torch.autograd.grad(
            out.square().sum(), [a] + list(net.parameters())))
    want = run()
    utils = importlib.import_module('erd_tpu_torch.utils')
    original = utils._IEEEConv2d
    utils._IEEEConv2d = bisect.no_cudnn_in_scope(original, on_cpu=True)
    bisect.Scope.convs = 0
    try:
        with bisect.switched(group):
            got = run()
            assert bisect.Scope.depth == 0
    finally:
        utils._IEEEConv2d = original
    assert bisect.Scope.convs == convs
    assert all(torch.equal(g, e) for g, e in zip(got, want))


def test_time_smoke_phases_times_every_phase_of_main(tmp_path, capsys):
    """Each phase_* function that main calls gets its seconds (twice
    called, twice counted), main's return code comes back, and the last
    line is the JSON report."""
    script = tmp_path / 'chip_smoke.py'
    script.write_text(
        'import time\n'
        'def phase_a():\n'
        '    time.sleep(0.05)\n'
        'def phase_b(n):\n'
        '    time.sleep(0.02 * n)\n'
        'def main():\n'
        '    phase_a()\n'
        '    phase_b(1)\n'
        '    phase_b(2)\n'
        '    return 3\n')
    assert time_smoke_phases.main([str(script)]) == 3
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report['rc'] == 3 and report['script'] == str(script)
    assert set(report['phases']) == {'phase_a', 'phase_b'}
    assert report['phases']['phase_a'] >= 0.05
    assert report['phases']['phase_b'] >= 0.06
    assert report['seconds'] >= sum(report['phases'].values())


def test_time_smoke_phases_runs_only_the_named_phases(tmp_path, capsys,
                                                      monkeypatch):
    """--only builds the kernels and runs the named phases alone, in the
    order given, each with the card line where it takes one; main is not
    run."""
    from erd_tpu_torch.ops import cuda_build
    built = []
    monkeypatch.setattr(cuda_build, 'build', lambda: built.append(1))
    monkeypatch.setenv('TRITON_CACHE_DIR', str(tmp_path))
    monkeypatch.syspath_prepend(str(tmp_path))
    ran = tmp_path / 'ran.txt'
    script = tmp_path / 'chip_smoke.py'
    script.write_text(
        f'ROOT = {time_smoke_phases.ROOT!r}\n'
        f'RAN = {str(ran)!r}\n'
        'def log(*parts):\n'
        '    with open(RAN, "a") as f:\n'
        '        f.write(" ".join(parts) + "\\n")\n'
        'def card_line():\n'
        '    return "a card, 700.00 W"\n'
        'def phase_a(np, torch):\n'
        '    log("a", np.__name__, torch.__name__)\n'
        'def phase_b(np, torch, card):\n'
        '    log("b", card)\n'
        'def phase_c(np, torch):\n'
        '    log("c")\n'
        'def main():\n'
        '    raise AssertionError("main ran")\n')
    assert time_smoke_phases.main(
        [str(script), '--only', 'phase_b,phase_a']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert lines[0] == 'a card, 700.00 W' and built == [1]
    assert report['rc'] == 0 and set(report['phases']) == {'phase_a',
                                                           'phase_b'}
    assert ran.read_text().splitlines() == ['b a card, 700.00 W',
                                            'a numpy torch']
