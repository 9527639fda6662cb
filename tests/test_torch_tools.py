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


def test_probe_parts_and_refusals(capsys, monkeypatch):
    """The probe's parts by kernel row (part 1 the NMS keep kernel): an
    unknown part name is refused with the list, and without a CUDA device
    every known part exits 1 before it measures anything."""
    from erd_tpu_torch.tools import atomic_backward_probe as probe
    parts = ['8b', '9b', '9', '7b', '1', '7', '10b', '10', '13a-b', '3',
             '6', '4', '5', '11a', '11a-floor', '15', '13a', '14', '2', '12b',
             'others']
    assert list(probe.PARTS) == parts
    assert probe.main(['--only', '1,nms']) == 2
    assert str(parts) in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert probe.main(['--only', '1,others']) == 1
    assert probe.main(['--only', '7,10b']) == 1
    assert probe.main(['--only', '10,13a-b']) == 1
    assert probe.main(['--only', '3,6']) == 1
    assert probe.main(['--only', '4,5']) == 1
    assert probe.main(['--only', '11a,15']) == 1
    assert probe.main(['--only', '13a,14']) == 1
    assert probe.main(['--only', '2,12b']) == 1


@pytest.mark.parametrize('name,parts,parent_only', [
    ('roi_align', 'ROI_FORWARD_PARTS', ()),
    ('carafe', 'CARAFE_BACKWARD_PARTS', ('no_weight_scratch',)),
    ('carafe', 'CARAFE_FORWARD_PARTS', ()),
    ('point_sample', 'POINT_BACKWARD_PARTS', ('stores_for_adds',)),
    ('ops/gfl_loss.py', 'GFL_LOSS_TRITON_PARTS',
     ('rows_8', 'rows_16', 'rows_64', 'warps_2', 'warps_8', 'no_class',
      'no_distribution')),
    ('gfl_loss', 'GFL_LOSS_PARTS', ()),
    ('atss', 'ATSS_PARTS', ()),
    ('ops/erd_distill.py', 'DISTILL_TRITON_PARTS',
     ('rows_8', 'rows_16', 'warps_2', 'warps_8', 'no_class',
      'no_distribution')),
    ('erd_distill', 'DISTILL_PARTS', ()),
    ('ers_select', 'ERS_PARTS', ()),
    ('soft_nms', 'SOFT_NMS_PARTS', ()),
    ('point_sample', 'POINT_FORWARD_PARTS', ()),
    ('mask_target', 'MASK_TARGET_PARTS', ()),
    ('integral_decode', 'DECODE_PARTS', ()),
    ('extra_nms', 'MASK_DECAY_PARTS', ())])
def test_probe_variants_fit_the_kernel_sources(name, parts, parent_only):
    """Parts 7, 10b, 10, 13a-b, 3, 6, 4, 5, 11a, 13a, 14, 2 and 12b build
    their variants from edited copies of csrc/roi_align.cu,
    csrc/carafe.cu, csrc/point_sample.cu, csrc/gfl_loss.cu, csrc/atss.cu,
    csrc/erd_distill.cu, csrc/ers_select.cu, csrc/soft_nms.cu,
    csrc/mask_target.cu, csrc/integral_decode.cu and csrc/extra_nms.cu (the
    parents of parts 3 and
    4: of their Triton modules ops/gfl_loss.py and ops/erd_distill.py):
    every variant but the parent designs' (marked
    parent-only) finds an edit set whose texts are all in the present
    source, and each replacement changes the text."""
    from erd_tpu_torch.tools import atomic_backward_probe as probe
    for variant, alternatives in getattr(probe, parts).items():
        edits = probe.fitting_edits(name, alternatives)
        if variant in parent_only:
            assert edits is None
            continue
        assert edits is not None, variant
        assert all(old != new for old, new in edits.items())


def test_roi_align_cost_counts_the_whole_batch():
    """chip_smoke.py's RoIAlign bound counts the map pixels, RoIs and
    output of every image of the batch: a 2-image call costs the sum of
    its images' calls."""
    import numpy as np
    smoke = importlib.import_module('chip_smoke')
    from erd_tpu_torch.ops import map_roi_levels
    rs = np.random.RandomState(2)
    feats = [torch.from_numpy(rs.randn(2, 3, h, w).astype(np.float32))
             for h, w in ((40, 64), (20, 32), (10, 16), (5, 8))]
    xy = rs.uniform(-20, [256, 160], (2, 30, 2))
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rs.uniform(2, 200, (2, 30, 2))], -1).astype(np.float32))
    levels = map_roi_levels(rois, 4)
    both = smoke.roi_align_cost(torch, feats, rois, levels, 14)
    one = [smoke.roi_align_cost(torch, [f[i:i + 1] for f in feats],
                                rois[i:i + 1], levels[i:i + 1], 14)
           for i in range(2)]
    assert both == tuple(map(sum, zip(*one)))
    assert both[1] == 2 * 30 * 3 * 196 * 48.0
    assert both[0] > 2 * 30 * 3 * 196 * 4


@pytest.mark.parametrize('group', [False, True])
def test_probe_nms_counts_match_a_direct_count(group):
    """Part 1's counts (``nms_stats``, in row chunks) against a count over
    the full pair matrix: the pairs right of the diagonal with a zero
    overlap, and the 64-bit words right of the diagonal that hold a
    suppression bit (the plain version's matrix, groups apart for
    set-NMS), K = 150 across three tiles."""
    import numpy as np

    from erd_tpu_torch.ops.nms import _suppress_matrix
    from erd_tpu_torch.tools.atomic_backward_probe import nms_stats
    rs = np.random.RandomState(3)
    b, k = 2, 150
    xy = rs.uniform(0, 100, (b, k, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rs.uniform(1, 30, (b, k, 2))], -1).astype(np.float32))
    valid = torch.from_numpy(rs.rand(b, k) > 0.2)
    sgroup = torch.from_numpy(rs.randint(0, 40, (b, k))) if group else None
    got = nms_stats(boxes, valid, 0.3, sgroup, rows=37)
    sup = _suppress_matrix(boxes, valid, 0.3)
    if group:
        sup &= sgroup[:, :, None] != sgroup[:, None, :]
    words = -(-k // 64)
    hit = torch.nn.functional.pad(sup, (0, 64 * words - k)).reshape(
        b, k, words, 64).any(-1)
    right = torch.arange(words)[None] >= (torch.arange(k) // 64)[:, None]
    x1, y1, x2, y2 = boxes.unbind(-1)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :]) -
          torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :]) -
          torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    later = torch.ones(k, k, dtype=torch.bool).triu(1)
    zero = ((iw == 0) | (ih == 0))[:, later]
    assert got['pairs'] == zero.numel() and got['valid'] == int(valid.sum())
    assert got['zero_overlap_share'] == int(zero.sum()) / zero.numel()
    assert got['mask_words'] == b * int(right.sum())
    assert got['nonzero_word_share'] == \
        int(hit[:, right].sum()) / hit[:, right].numel()
    assert 0 < got['nonzero_word_share'] < 1


def test_probe_corner_stats_match_a_direct_count():
    """Part 13a-b's corner counts (``corner_stats``) against a loop over
    every point's four bilinear corners: the share off the map, the adds a
    touched pixel, the share of 8 x 32 tiles reached and the corners an
    8 x 8 tile takes; points on the edges 0 and 1 and off the map."""
    import numpy as np

    from erd_tpu_torch.tools.atomic_backward_probe import corner_stats
    rs = np.random.RandomState(4)
    n, h, w, k = 2, 19, 45, 60
    pts = rs.uniform(-0.1, 1.1, (n, k, 2)).astype(np.float32)
    pts[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    pts[1, :20] = pts[1, 0]
    got = corner_stats(torch.from_numpy(pts), (n, 3, h, w))
    pixels, tiles, tile8 = {}, set(), {}
    for i in range(n):
        for p in range(k):
            x0 = int(np.floor(np.float64(pts[i, p, 0]) * w - 0.5))
            y0 = int(np.floor(np.float64(pts[i, p, 1]) * h - 0.5))
            for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                           (y0 + 1, x0 + 1)):
                if 0 <= yy < h and 0 <= xx < w:
                    pixels[i, yy, xx] = pixels.get((i, yy, xx), 0) + 1
                    tiles.add((i, yy // 8, xx // 32))
                    key = (i, yy // 8, xx // 8)
                    tile8[key] = tile8.get(key, 0) + 1
    on_map = sum(pixels.values())
    assert got['points_per_image'] == k
    assert got['corners_off_map'] == pytest.approx(1 - on_map / (4 * n * k))
    assert got['adds_per_touched_pixel_mean'] == pytest.approx(
        on_map / len(pixels))
    assert got['adds_per_touched_pixel_max'] == max(pixels.values()) >= 20
    assert got['touched_pixels'] == pytest.approx(len(pixels) / (n * h * w))
    assert got['tiles_reached'] == pytest.approx(len(tiles) / (n * 3 * 2))
    assert got['corners_per_8x8_tile_max'] == max(tile8.values())
    assert got['corners_per_8x8_tile_mean'] == pytest.approx(
        on_map / len(tile8))
