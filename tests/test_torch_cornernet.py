"""Port parity: CornerNet serving vs erd_tpu, float32 on the CPU.

The network is the zoo test's small hourglass (tests/test_zoo_detectors.py:
stage channels (16, 16, 24), one block a level, 2 downsamplings, 2 stacks,
4 classes, top 20 corners) with erd_tpu's own initialisation through
``params_from_jax``; BN statistics and biases are perturbed so that the BN
layers do work. Tolerances, each with its reason:
- corner_pool and local_maximum: exactly (maxima);
- HourglassNet and the network's outputs: 1e-4 * max|out| (convolutions
  summed in another order, through ~40 layers);
- predict from erd_tpu's network outputs: masks, labels and the number of
  candidates exactly, scores 1e-6 (the gaussian decays' exp differs from
  XLA's by an ulp), boxes 1e-4 px. The heatmap logits sit on a 1/64 grid,
  so equal logits are exact ties on both sides and the sigmoids' last-bit
  differences cannot reorder the top-k.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.models.backbones.hourglass import HourglassNet as JHourglass
from erd_tpu.models.detectors.cornernet import \
    CornerNetDetector as JCornerNet
from erd_tpu.ops import corner_pool as j_corner_pool
from erd_tpu.ops.gaussian import local_maximum as j_local_maximum
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector, inference_detector
from erd_tpu_torch.config import Config
from erd_tpu_torch.models import CornerNetDetector
from erd_tpu_torch.models.backbones import HourglassNet
from erd_tpu_torch.models.weight_import import (load_torch_checkpoint_file,
                                                 params_from_jax)
from erd_tpu_torch.ops import corner_pool, corner_pool_plain, local_maximum
from erd_tpu_torch.structures import GTInstances, ImageMeta, stack_to

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs', 'cornernet',
                      'cornernet_hourglass104_8xb6-210e-mstest_coco.py')
SMALL = dict(num_classes=4, stage_channels=(16, 16, 24),
             stage_blocks=(1, 1, 1), downsample_times=2, corner_topk=20)
CANVAS = (64, 96)


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, 1)))


def assert_close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def perturbed(variables, seed=0):
    """BN mean N(0, 0.2^2), var U(0.5, 2), scale U(0.5, 1.5), biases
    N(0, 0.05^2), in tree order."""
    rs = np.random.RandomState(seed)
    for name, leaf in jax.tree_util.tree_leaves_with_path(variables):
        key = getattr(name[-1], 'key', None)
        if key == 'mean':
            leaf[...] = rs.normal(0, 0.2, leaf.shape)
        elif key == 'var':
            leaf[...] = rs.uniform(0.5, 2.0, leaf.shape)
        elif key == 'scale':
            leaf[...] = rs.uniform(0.5, 1.5, leaf.shape)
        elif key == 'bias':
            leaf[...] = rs.normal(0, 0.05, leaf.shape)
    return variables


@pytest.fixture(scope='module')
def cornernet():
    jdet = JCornerNet(**SMALL)
    variables = perturbed(to_numpy(jdet.init(jax.random.PRNGKey(0),
                                             image_shape=CANVAS)))
    det = CornerNetDetector(**SMALL)
    net = det.init(seed=0, device='cpu')
    net.load_state_dict(params_from_jax(variables), strict=True)
    return jdet, variables, det, net


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize('direction', ['top', 'bottom', 'left', 'right'])
@pytest.mark.parametrize('hw', [(7, 9), (12, 5), (1, 6)])
def test_corner_pool_plain_matches_jax_exactly(direction, hw):
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    x[0, :, 1] = 0.5  # ties along a whole column
    want = np.asarray(j_corner_pool(jnp.asarray(x), direction))
    got = corner_pool(nchw(x), direction)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    xb = nchw(x).bfloat16()
    gotb = corner_pool_plain(xb, direction)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        gotb.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(j_corner_pool(jnp.asarray(xb.float().permute(
            0, 2, 3, 1).numpy()), direction)))
    with pytest.raises(ValueError):
        corner_pool(nchw(x), 'up')


# the NaN rule of lax.cummax (fault 3.11): a NaN and every element after it
# in scan order read NaN
NAN_RAY = [1, np.nan, 0.5, 2, 2, 0]


def nan_rays(case, direction):
    """NHWC maps with NaNs in their rays: ``repro`` one ray along the
    direction's axis holding NAN_RAY; ``scattered`` ReLU'd noise (runs of
    tied zeros) with 8 % NaNs, a ray that is all NaN, rays with a NaN first
    and last, and bare zeros after a NaN."""
    along_h = direction in ('top', 'bottom')
    if case == 'repro':
        x = np.asarray(NAN_RAY, np.float32)
        return x.reshape((1, 6, 1, 1) if along_h else (1, 1, 6, 1))
    rs = np.random.RandomState(5)
    x = np.maximum(rs.randn(2, 9, 11, 3), 0).astype(np.float32)
    x[rs.rand(*x.shape) < 0.08] = np.nan
    if along_h:
        x[0, :, 2, 0] = np.nan
        x[1, 0, 3, 1] = x[1, -1, 4, 1] = np.nan
        x[1, 4:, 5, 2] = 0
    else:
        x[0, 2, :, 0] = np.nan
        x[1, 3, 0, 1] = x[1, 4, -1, 1] = np.nan
        x[1, 5, 4:, 2] = 0
    return x


@pytest.mark.parametrize('direction', ['top', 'bottom', 'left', 'right'])
@pytest.mark.parametrize('case', ['repro', 'scattered'])
def test_corner_pool_carries_nan_as_jax(direction, case):
    """Fault 3.11: the forward carries a NaN along the ray as erd_tpu's
    lax.cummax does, in float32 and bf16."""
    x = nan_rays(case, direction)
    want = np.asarray(j_corner_pool(jnp.asarray(x), direction))
    assert np.isnan(want).any() and not np.isnan(want).all()
    got = corner_pool(nchw(x), direction).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    if case == 'repro':
        ray = got.reshape(-1)
        expect = {'bottom': [1] + [np.nan] * 5, 'right': [1] + [np.nan] * 5,
                  'top': [np.nan, np.nan, 2, 2, 2, 0],
                  'left': [np.nan, np.nan, 2, 2, 2, 0]}[direction]
        np.testing.assert_array_equal(ray, np.asarray(expect, np.float32))
    xb = nchw(x).bfloat16()
    np.testing.assert_array_equal(
        corner_pool_plain(xb, direction).float().permute(0, 2, 3, 1)
        .numpy(), np.asarray(j_corner_pool(jnp.asarray(
            xb.float().permute(0, 2, 3, 1).numpy()), direction)))


def test_local_maximum_matches_jax():
    """3x3 window max padded with -inf; plateaus of equal values all
    stay."""
    heat = np.round(np.random.RandomState(2).rand(2, 9, 13, 3) * 8) / 8
    heat = heat.astype(np.float32)
    want = np.stack([np.asarray(j_local_maximum(jnp.asarray(h)))
                     for h in heat])
    got = local_maximum(nchw(heat)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).mean() > 0.3


# ------------------------------------------------------------- networks
def test_hourglass_matches_jax():
    """HourglassNet alone: 3 stacks of depth 3, every BN perturbed."""
    kw = dict(downsample_times=3, num_stacks=3, stage_channels=(8, 8, 12, 16),
              stage_blocks=(1, 2, 1, 2), feat_channel=8)
    jnet = JHourglass(**kw)
    x = np.random.RandomState(3).randn(1, 64, 96, 3).astype(np.float32)
    variables = perturbed(to_numpy(jnet.init(jax.random.PRNGKey(1),
                                             jnp.asarray(x))), seed=4)
    want = jnet.apply(variables, jnp.asarray(x))
    net = HourglassNet(**kw).eval()
    # an empty tl_pool_0 scope marks the tree as CornerNet's
    state = params_from_jax(dict(
        params={'backbone': variables['params'], 'tl_pool_0': {}},
        batch_stats={'backbone': variables['batch_stats']}))
    net.load_state_dict({k[len('backbone.'):]: v for k, v in state.items()},
                        strict=True)
    with torch.no_grad():
        got = net(nchw(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1), w, 1e-4)
    with pytest.raises(ValueError, match='multiples of'):
        net(torch.zeros(1, 3, 64, 88))


def test_cornernet_forward_raw_matches_jax(cornernet):
    jdet, variables, det, net = cornernet
    images = np.random.RandomState(5).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    want = jdet.forward_jit(variables, jnp.asarray(images))
    got = det.forward_raw(net, torch.from_numpy(images))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert_close(g[key].permute(0, 2, 3, 1), w[key], 1e-4)
    last = net.last_stack(det.preprocessor(torch.from_numpy(images)))
    for key in last:
        assert torch.equal(last[key], got[-1][key])


def grid_outputs(rs, b, hw, c):
    """One stack's outputs on a 1/64 grid (NHWC): heat logits N(-1, 1.5^2),
    embeddings N(0, 0.4^2), offsets U(0, 1)."""
    def g(a):
        return (np.round(a * 64) / 64).astype(np.float32)
    return dict(tl_heat=g(rs.normal(-1, 1.5, (b, *hw, c))),
                br_heat=g(rs.normal(-1, 1.5, (b, *hw, c))),
                tl_emb=g(rs.normal(0, 0.4, (b, *hw, 1))),
                br_emb=g(rs.normal(0, 0.4, (b, *hw, 1))),
                tl_off=g(rs.uniform(0, 1, (b, *hw, 2))),
                br_off=g(rs.uniform(0, 1, (b, *hw, 2))))


@pytest.mark.parametrize('nms_type', ['soft_nms', 'nms'])
def test_cornernet_decode_matches_jax(cornernet, nms_type):
    """The last stack's decode and NMS from identical outputs: local maxima,
    the top-20 corners, the 20 x 20 pair grid, score_thr, the rescale and
    gaussian soft-NMS (or greedy NMS)."""
    jdet, variables, det, _ = cornernet
    jdet, det = copy.copy(jdet), dataclasses.replace(det, nms_type=nms_type)
    jdet.nms_type = nms_type
    out = grid_outputs(np.random.RandomState(6), 2, (16, 24), 4)
    pairs = [((60, 90), (120, 180), (0.5, 0.5)),
             ((64, 80), (64, 80), (1.0, 1.0))]
    jmeta = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                         *[JImageMeta.make(*p) for p in pairs])
    meta = stack_to([ImageMeta.make(*p) for p in pairs], 'cpu')
    jdet.forward_raw = lambda v, images: [out, out]
    want = jax.jit(jdet.predict)(variables, dict(
        images=jnp.zeros((2, *CANVAS, 3), jnp.uint8), meta=jmeta))
    got = det.nms(*det.decode({k: nchw(v) for k, v in out.items()}, CANVAS,
                              meta))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.sum() > 20 and (got.num_candidates > 10).all()
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=0, atol=1e-4)


def test_cornernet_predict_matches_jax(cornernet):
    """The whole predict of both: boxes, labels and scores from the network
    on the same images, within the network's tolerance."""
    jdet, variables, det, net = cornernet
    images = np.random.RandomState(7).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    pairs = [((64, 96), (64, 96), (1.0, 1.0))] * 2
    jmeta = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                         *[JImageMeta.make(*p) for p in pairs])
    meta = stack_to([ImageMeta.make(*p) for p in pairs], 'cpu')
    want = jax.jit(jdet.predict)(variables, dict(images=jnp.asarray(images),
                                                 meta=jmeta))
    got = det.predict(net, dict(images=torch.from_numpy(images), meta=meta))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.sum() > 0
    m = got.mask.numpy()
    np.testing.assert_array_equal(got.labels.numpy()[m],
                                  np.asarray(want.labels)[m])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=0, atol=1e-2)


# --------------------------------------------------------- build_detector
def test_build_detector_serves_the_config_in_float32():
    """The HG-104 config builds a float32 CornerNet with erd_tpu's test
    keys (its bf16 compute_dtype is not read, as in erd_tpu) and erd_tpu's
    frozen_stages; build_detector's raise paths; the small network's loss
    runs in train mode and leaves it in eval mode; inference_detector on a
    96x128 canvas, whose sides are multiples of the small hourglass's
    4 * 2^2."""
    cfg = Config.fromfile(CONFIG)
    det = build_detector(cfg.model)
    assert type(det) is CornerNetDetector
    assert (det.num_classes, det.corner_topk, det.distance_threshold,
            det.score_thr, det.max_per_img, det.nms_iou, det.nms_type,
            det.soft_nms_sigma) == (80, 100, 0.5, 0.05, 100, 0.5,
                                    'soft_nms', 0.5)
    assert (det.stage_channels, det.stage_blocks, det.num_stacks) == \
        ((256, 256, 384, 384, 384, 512), (2, 2, 2, 2, 2, 4), 2)
    assert det.preprocessor.compute_dtype == torch.float32
    assert det.frozen_stages == 1
    for key, value in (('neck', dict(type='FPN')), ('dcn_stages',
                                                     (0, 1, 1, 1))):
        with pytest.raises(NotImplementedError, match='not ported yet'):
            build_detector(Config(type='CornerNet', **{key: value}))
    with pytest.raises(NotImplementedError, match='"Zoo, after the main'):
        build_detector(Config(type='CentripetalNet'))
    small = CornerNetDetector(**SMALL)
    net = small.init(seed=0, device='cpu')
    gt = GTInstances.pad([[8, 8, 60, 50]], [2], 3)
    batch = dict(images=torch.zeros((1, 64, 96, 3), dtype=torch.uint8),
                 gt=stack_to([gt], 'cpu'))
    before = net.backbone.stem_conv.bn.running_mean.clone()
    losses = small.loss(net, batch)
    assert set(losses) == {'loss_heatmap', 'loss_pull', 'loss_push',
                           'loss_offset'}
    assert all(torch.isfinite(v) for v in losses.values())
    assert not net.training and not torch.equal(
        before, net.backbone.stem_conv.bn.running_mean)
    with pytest.raises(NotImplementedError, match='params_from_jax'):
        load_torch_checkpoint_file(net, 'unused.pth')
    img = np.random.RandomState(8).randint(0, 256, (90, 120, 3), np.uint8)
    res = inference_detector(small, net, img, scale=(128, 96))
    assert np.isfinite(res.bboxes).all() and len(res.scores) <= 100
