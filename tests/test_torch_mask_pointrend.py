"""Port parity: Mask R-CNN and PointRend serving vs erd_tpu, on the CPU.

Weights come from erd_tpu's own initialisation through ``params_from_jax``
(depth 18, 3 classes, 64x96 canvases, as tests/test_mask_rcnn.py); inputs
are made with numpy from seeds. Tolerances, each with its reason:
- point_sample: 1e-6 * max|map|, the same bilinear arithmetic (XLA may
  fuse a product and a sum);
- the bilinear x2 against jax.image.resize: 1e-6 * max|x| (JAX sums the
  0.75 / 0.25 taps as a dot over its weight matrix, torch as two products,
  so an output may differ by an ulp, the corners too);
- the mask heads: 1e-5 * max|out| (float32 products summed in another
  order; in bf16 both sides round the same weights);
- the networks: 1e-4 * max|out|, as tests/test_torch_frcnn.py (erd_tpu's
  space-to-depth stem reassociates the stem's sums);
- predict from erd_tpu's FPN levels and RPN outputs: masks and labels
  exactly, scores 1e-5, boxes 1e-2 px (as Faster R-CNN's); mask
  probabilities 1e-4 (RoIAlign's sums in another order and the heads');
  PointRend's refined cells are the same but where two cells' uncertainties
  are within the upsample's ulp of each other at the top-k's edge: there
  the two sides refine different cells, and at most 1e-5 of the mask
  cells may differ beyond 1e-4 (2 of 627200 here).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.models.detectors.mask_rcnn import \
    MaskRCNNDetector as JMaskRCNN
from erd_tpu.models.detectors.point_rend import \
    PointRendDetector as JPointRend
from erd_tpu.models.layers import cast_compute_params
from erd_tpu.ops.sampling import point_sample as j_point_sample
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector, inference_detector
from erd_tpu_torch.config import Config
from erd_tpu_torch.models import MaskRCNNDetector, PointRendDetector
from erd_tpu_torch.models.detectors.point_rend import (cell_centres,
                                                       upsample2x)
from erd_tpu_torch.models.weight_import import (load_torch_checkpoint_file,
                                                 params_from_jax)
from erd_tpu_torch.ops import point_sample, point_sample_plain
from erd_tpu_torch.structures import ImageMeta, stack_to

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'mask_rcnn': os.path.join(ROOT, 'configs', 'mask_rcnn',
                              'mask_rcnn_r50_fpn_1x_coco.py'),
    'point_rend': os.path.join(ROOT, 'configs', 'point_rend',
                               'point-rend_r50-caffe_fpn_ms-1x_coco.py')}
NUM_CLASSES = 3
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


def metas():
    """Two images in the 64x96 canvas, the first one rescaled."""
    pairs = [((60, 90), (120, 180), (0.5, 0.5)),
             ((64, 80), (64, 80), (1.0, 1.0))]
    j = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                     *[JImageMeta.make(*p) for p in pairs])
    return j, stack_to([ImageMeta.make(*p) for p in pairs], 'cpu')


def models(kind):
    """erd_tpu's detector and variables, and the port's with the same
    weights; BN statistics and biases perturbed, the RPN objectness kernel
    widened to N(0, 0.3) and fc_cls to N(0, 0.1), so that scores spread
    (logits of a few units: the head's float32 sums, reassociated, stay
    within the scores' 1e-5)."""
    jcls, cls = {'mask_rcnn': (JMaskRCNN, MaskRCNNDetector),
                 'point_rend': (JPointRend, PointRendDetector)}[kind]
    jdet = jcls(num_classes=NUM_CLASSES, depth=18)
    variables = to_numpy(jdet.init(jax.random.PRNGKey(0),
                                   image_shape=CANVAS))
    rs = np.random.RandomState(0)
    for name, leaf in jax.tree_util.tree_leaves_with_path(variables):
        key = getattr(name[-1], 'key', None)
        if key == 'mean':
            leaf[...] = rs.normal(0, 0.2, leaf.shape)
        elif key == 'var':
            leaf[...] = rs.uniform(0.5, 2.0, leaf.shape)
        elif key == 'bias':
            leaf[...] = rs.normal(0, 0.05, leaf.shape)
    for scope, mod, std in (('rpn_head', 'rpn_cls', 0.3),
                            ('bbox_head', 'fc_cls', 0.1)):
        k = variables['params'][scope][mod]['kernel']
        k[...] = rs.normal(0, std, k.shape)
    det = cls(num_classes=NUM_CLASSES, depth=18)
    net = det.init(seed=0, device='cpu')
    net.load_state_dict(params_from_jax(variables), strict=True)
    return jdet, variables, det, net


@pytest.fixture(scope='module')
def mask_rcnn():
    return models('mask_rcnn')


@pytest.fixture(scope='module')
def point_rend():
    return models('point_rend')


# ---------------------------------------------------------- point_sample
def point_cases(rs, n, k):
    """Points in [0, 1]: uniform ones, the edges 0 and 1 (a sample 0.5 px
    outside the map, two corners off it), cell centres and exact pixel
    centres (weights 0 and 1)."""
    pts = rs.uniform(0, 1, (n, k, 2)).astype(np.float32)
    pts[:, :8] = np.asarray([[0, 0], [1, 1], [0, 1], [1, 0], [0, 0.5],
                             [0.5, 1], [1 / 28, 27 / 28], [0.5, 0.5]],
                            np.float32)
    return pts


@pytest.mark.parametrize('form', ['coarse', 'fine'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_point_sample_plain_matches_jax(form, dtype):
    """Both PointRend call forms: per-RoI 14x14 maps of C logits, each at
    its own points; one P2 map per image at all its RoIs' points. bf16
    maps: erd_tpu samples the map widened to float32, as the port."""
    rs = np.random.RandomState(1)
    n, c, hw, k = (6, 5, (14, 14), 40) if form == 'coarse' else \
        (2, 16, (15, 23), 300)
    maps = rs.randn(n, *hw, c).astype(np.float32) * 3
    maps = np.asarray(torch.from_numpy(maps).to(getattr(torch, dtype))
                      .float())
    pts = point_cases(rs, n, k)
    want = np.stack([np.asarray(j_point_sample(jnp.asarray(m),
                                               jnp.asarray(p)))
                     for m, p in zip(maps, pts)])
    tmaps = nchw(maps).to(getattr(torch, dtype))
    got = point_sample(tmaps, torch.from_numpy(pts))
    assert got.dtype == torch.float32
    assert_close(got, want, 1e-6)
    # channels-last memory (the coarse head's view) reads the same
    got_cl = point_sample_plain(tmaps.contiguous(
        memory_format=torch.channels_last), torch.from_numpy(pts))
    assert torch.equal(got_cl, got)


def test_point_sample_align_corners_plain_only():
    rs = np.random.RandomState(2)
    maps = rs.randn(2, 9, 11, 4).astype(np.float32)
    pts = point_cases(rs, 2, 30)
    want = np.stack([np.asarray(j_point_sample(jnp.asarray(m),
                                               jnp.asarray(p), True))
                     for m, p in zip(maps, pts)])
    assert_close(point_sample(nchw(maps), torch.from_numpy(pts), True),
                 want, 1e-6)
    with pytest.raises(ValueError):
        point_sample(nchw(maps), torch.from_numpy(pts[:1]))


# ------------------------------------------------------------- mask heads
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fcn_mask_head_matches_jax(mask_rcnn, dtype):
    """4 convs, the 2x2 stride-2 transposed conv (flax's unflipped kernel
    against torch's ConvTranspose2d after the import's flip), conv_logits;
    bf16: float32 features, bf16-rounded weights, float32 products."""
    jdet, variables, _, _ = mask_rcnn
    feats = np.random.RandomState(3).randn(7, 14, 14, 256).astype(np.float32)
    want = jdet.net.apply(cast_compute_params(variables,
                                              getattr(jnp, dtype)),
                          jnp.asarray(feats), method='mask_forward')
    assert want.dtype == jnp.float32
    det = MaskRCNNDetector(num_classes=NUM_CLASSES, depth=18,
                           compute_dtype=getattr(torch, dtype))
    net = det.init(seed=1, device='cpu')
    net.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = net.roi_head.mask_head(nchw(feats))
    assert got.shape == (7, NUM_CLASSES, 28, 28)
    assert_close(got.permute(0, 2, 3, 1), want, 1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_coarse_and_point_heads_match_jax(point_rend, dtype):
    """The coarse head (fc0's rows permuted from erd_tpu's (14, 14, C)
    flatten, fc_logits kept in its (14, 14, C) order) and the point head
    (coarse logits concatenated after every fc)."""
    jdet, variables, _, _ = point_rend
    rs = np.random.RandomState(4)
    feats = rs.randn(5, 14, 14, 256).astype(np.float32)
    fine = rs.randn(5, 30, 256).astype(np.float32)
    coarse_pts = rs.randn(5, 30, NUM_CLASSES).astype(np.float32)
    v = cast_compute_params(variables, getattr(jnp, dtype))
    want_c = jdet.net.apply(v, jnp.asarray(feats), method='coarse_forward')
    want_p = jdet.net.apply(v, jnp.asarray(fine), jnp.asarray(coarse_pts),
                            method='point_forward')
    det = PointRendDetector(num_classes=NUM_CLASSES, depth=18,
                            compute_dtype=getattr(torch, dtype))
    net = det.init(seed=1, device='cpu')
    net.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got_c = net.roi_head.mask_head(nchw(feats))
        got_p = net.roi_head.point_head(torch.from_numpy(fine),
                                        torch.from_numpy(coarse_pts))
    assert got_c.shape == (5, NUM_CLASSES, 14, 14)
    assert_close(got_c.permute(0, 2, 3, 1), want_c, 1e-5)
    assert_close(got_p, want_p, 1e-5)


@pytest.mark.parametrize('size', [14, 28])
def test_upsample2x_matches_jax_resize(size):
    x = np.random.RandomState(5).randn(40, size, size).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (40, 2 * size, 2 * size),
                                       method='bilinear'))
    got = upsample2x(torch.from_numpy(x)).numpy()
    # JAX normalises the one in-range tap of an edge sample to weight 1,
    # torch clamps the coordinate onto the edge: both take the edge pixel
    assert_close(got, want, 1e-6)
    np.testing.assert_array_equal(got[:, 0, 0], x[:, 0, 0])


def test_cell_centres_and_tie_order():
    """Cell centres (x + 0.5) / size; equal uncertainties come lowest index
    first, as lax.top_k gives them."""
    from erd_tpu_torch.ops.misc import topk_stable
    idx = torch.tensor([[0, 5, 27, 783]])
    np.testing.assert_allclose(cell_centres(idx, 28)[0].numpy(),
                               [[0.5 / 28, 0.5 / 28], [5.5 / 28, 0.5 / 28],
                                [27.5 / 28, 0.5 / 28],
                                [27.5 / 28, 27.5 / 28]], rtol=1e-6)
    unc = -np.abs(np.round(np.random.RandomState(6).randn(3, 64) * 4) / 4)
    unc = unc.astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(unc), 20)
    _, got = topk_stable(torch.from_numpy(unc), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- predict
def check_predict(jdet, variables, det, net, min_dets, swaps=0.0):
    images = np.random.RandomState(7).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    jmeta, meta = metas()
    (jrpn_cls, jrpn_reg), jhead, *jmask = jdet.forward_jit(
        variables, jnp.asarray(images))
    out = det.forward_raw(net, torch.from_numpy(images))
    (rpn_cls, rpn_reg), head = out
    for g, w in zip(list(rpn_cls) + list(rpn_reg) + list(head),
                    list(jrpn_cls) + list(jrpn_reg) + list(jhead)):
        assert_close(g, w, 1e-4)
    want_res, want_masks = jax.jit(jdet.predict)(
        variables, dict(images=jnp.asarray(images), meta=jmeta))
    feats = jdet.net.apply(variables, jdet.preprocessor(jnp.asarray(images)),
                           method='extract_feat')
    res, masks = det.predict_from_feats(
        net, CANVAS, [nchw(f) for f in feats],
        [torch.from_numpy(np.array(c)) for c in jrpn_cls],
        [torch.from_numpy(np.array(r)) for r in jrpn_reg], meta)
    np.testing.assert_array_equal(res.mask.numpy(),
                                  np.asarray(want_res.mask))
    assert res.mask.sum() >= min_dets
    np.testing.assert_array_equal(res.labels.numpy(),
                                  np.asarray(want_res.labels))
    np.testing.assert_allclose(res.scores.numpy(),
                               np.asarray(want_res.scores), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res.bboxes.numpy(),
                               np.asarray(want_res.bboxes), rtol=0,
                               atol=1e-2)
    assert masks.shape == want_masks.shape
    got, want = masks.numpy(), np.asarray(want_masks)
    off = np.abs(got - want) > 1e-4
    assert off.mean() <= swaps, off.mean()
    np.testing.assert_allclose(got[~off], want[~off], rtol=0, atol=1e-4)
    return images, meta, masks


def test_mask_rcnn_predict_matches_jax(mask_rcnn):
    images, meta, masks = check_predict(*mask_rcnn, min_dets=50)
    assert masks.shape[1:] == (100, 28, 28)
    _, _, det, net = mask_rcnn
    own_res, own_masks = det.predict(net, dict(
        images=torch.from_numpy(images), meta=meta))
    assert own_masks.shape == (2, 100, 28, 28)
    assert ((own_masks >= 0) & (own_masks <= 1)).all()


def test_point_rend_predict_matches_jax(point_rend):
    _, _, masks = check_predict(*point_rend, min_dets=50, swaps=1e-5)
    # 14 -> 28 -> 56 after the two subdivision steps
    assert masks.shape[2:] == (56, 56)


def test_inference_detector_serves_mask_configs():
    """The mask configs through build_detector at depth 18 on the CPU:
    inference_detector returns the boxes of predict's (DetResults, masks),
    as erd_tpu's evaluation loop reads them."""
    img = np.random.RandomState(8).randint(0, 256, (90, 120, 3), np.uint8)
    for kind, path in CONFIGS.items():
        cfg = Config.fromfile(path)
        cfg.model.depth = 18
        det = build_detector(cfg.model)
        assert type(det) is {'mask_rcnn': MaskRCNNDetector,
                             'point_rend': PointRendDetector}[kind]
        assert det.compute_dtype == torch.bfloat16
        net = det.init(seed=0, device='cpu')
        out = inference_detector(det, net, img, scale=(160, 128))
        assert out.bboxes.shape[1] == 4 and np.isfinite(out.bboxes).all()


def test_build_detector_and_loader_rules(point_rend):
    """GN / WS heads and Mask R-CNN's seesaw loss raise with the zoo item,
    as does a swapped neck; mask training raises; PointRend loads no mmdet
    checkpoint."""
    for key, value in (('loss_cls', 'seesaw'), ('head_norm', 'GN'),
                       ('conv_ws', True)):
        with pytest.raises(NotImplementedError,
                           match='"Zoo, after the main path"'):
            build_detector(Config(type='MaskRCNN', **{key: value}))
    with pytest.raises(NotImplementedError, match='not ported yet'):
        build_detector(Config(type='PointRend',
                              neck=dict(type='FPN_CARAFE')))
    det, net = point_rend[2:]
    with pytest.raises(NotImplementedError, match='point loss'):
        det.loss(net, {})
    with pytest.raises(NotImplementedError, match='params_from_jax'):
        load_torch_checkpoint_file(net, 'unused.pth')


def test_mask_head_state_dict_has_mmdet_names(mask_rcnn):
    """mmdet's FCNMaskHead keys and shapes: ConvModule convs, a
    ConvTranspose2d upsample (I, O, 2, 2) and a 1x1 conv_logits."""
    state = mask_rcnn[3].state_dict()
    got = {k: tuple(v.shape) for k, v in state.items()
           if k.startswith('roi_head.mask_head.')}
    want = {}
    for i in range(4):
        want[f'roi_head.mask_head.convs.{i}.conv.weight'] = (256, 256, 3, 3)
        want[f'roi_head.mask_head.convs.{i}.conv.bias'] = (256,)
    want['roi_head.mask_head.upsample.weight'] = (256, 256, 2, 2)
    want['roi_head.mask_head.upsample.bias'] = (256,)
    want['roi_head.mask_head.conv_logits.weight'] = (NUM_CLASSES, 256, 1, 1)
    want['roi_head.mask_head.conv_logits.bias'] = (NUM_CLASSES,)
    assert got == want
