"""Port parity: erd_tpu_torch's Faster R-CNN serving path vs erd_tpu, fp32
on the CPU.

Parameters come from ``FasterRCNNDetector(num_classes=4, depth=18).init``
in erd_tpu through ``params_from_jax``; inputs are made with numpy from a
seed. Tolerances, each with its reason:
- the delta coder, rtol 1e-6: the same float32 ops, but exp and log differ
  from XLA's by an ulp;
- anchors, exactly (the same numpy code);
- RoIAlign, rtol 1e-5 (+ 1e-6 * max|feat|): the same sample arithmetic, the
  2x2 means summed in another order; the level map exactly;
- soft-NMS: selections, labels and masks exactly; linear scores to 1e-6,
  gaussian ones to 1e-5 (each step's exp differs from XLA's by up to an
  ulp, and a score carries the product of all its decays);
- proposals from identical RPN outputs: masks exactly, boxes 1e-4 px;
- the bbox head, rtol 1e-5 (float32 products summed in another order);
- predict from identical inputs: masks and labels exactly, scores 1e-5,
  boxes 1e-2 px; the network at 1e-4 * max|out| as in test_torch_model.py
  (erd_tpu's space-to-depth stem reassociates the stem's sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.models.detectors.faster_rcnn import \
    FasterRCNNDetector as JFasterRCNN
from erd_tpu.models.heads.bbox_head import rcnn_predict_single as j_rcnn
from erd_tpu.models.heads.gfl_head import AnchorContext as JAnchorContext
from erd_tpu.models.heads.gfl_head import GFLTestConfig as JTestConfig
from erd_tpu.models.heads.rpn_head import ProposalConfig as JProposalConfig
from erd_tpu.models.heads.rpn_head import \
    rpn_anchor_generator as j_rpn_anchor_generator
from erd_tpu.models.heads.rpn_head import rpn_proposals as j_rpn_proposals
from erd_tpu.models.layers import cast_compute_params
from erd_tpu.models.layers import max_pool_torch as j_max_pool
from erd_tpu.models.layers import nearest_upsample_to as j_upsample
from erd_tpu.models.layers import torch_pad
from erd_tpu.ops.nms import soft_nms_select as j_soft_nms_select
from erd_tpu.ops.roi_align import map_roi_levels as j_map_roi_levels
from erd_tpu.ops.roi_align import multilevel_roi_align as j_multilevel
from erd_tpu.ops.roi_align import roi_align as j_roi_align
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu.task.coder import DeltaXYWHBBoxCoder as JCoder
from erd_tpu_torch.models import FasterRCNNDetector
from erd_tpu_torch.models.heads import (AnchorContext, GFLTestConfig,
                                        ProposalConfig, rcnn_predict,
                                        rpn_anchor_generator, rpn_proposals)
from erd_tpu_torch.models.layers import (Conv2d, max_pool_torch,
                                         nearest_upsample_to)
from erd_tpu_torch.models.weight_import import params_from_jax
from erd_tpu_torch.ops import (map_roi_levels, multilevel_roi_align,
                               roi_align, roi_align_level, roi_align_plain,
                               soft_nms_select)
from erd_tpu_torch.structures import ImageMeta, stack_to
from erd_tpu_torch.task import DeltaXYWHBBoxCoder

torch.set_num_threads(2)

NUM_CLASSES = 4
CANVAS = (128, 160)
STRIDES = (4, 8, 16, 32)


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def metas():
    """Two images in the 128x160 canvas, one rescaled."""
    pairs = [((120, 150), (240, 300), (0.5, 0.5)),
             ((128, 144), (128, 144), (1.0, 1.0))]
    j = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                     *[JImageMeta.make(*p) for p in pairs])
    t = stack_to([ImageMeta.make(*p) for p in pairs], 'cpu')
    return j, t


@pytest.fixture(scope='module')
def frcnn():
    """erd_tpu's detector and variables, and the port's with the same
    weights. BN statistics and affine parameters are perturbed, and the
    RPN objectness and fc_cls kernels widened to N(0, 0.3), so that scores
    spread (random weights put every score at ~0.5 and ~1/5) and ties
    between near-equal scores stay rare."""
    jdet = JFasterRCNN(num_classes=NUM_CLASSES, depth=18)
    variables = to_numpy(jdet.init(jax.random.PRNGKey(0),
                                   image_shape=CANVAS))
    rs = np.random.RandomState(0)
    for name, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = [getattr(k, 'key', None) for k in name]
        if keys[-1] == 'mean':
            leaf[...] = rs.normal(0, 0.2, leaf.shape)
        elif keys[-1] == 'var':
            leaf[...] = rs.uniform(0.5, 2.0, leaf.shape)
        elif keys[-1] == 'bias':
            leaf[...] = rs.normal(0, 0.05, leaf.shape)
    for scope, mod in (('rpn_head', 'rpn_cls'), ('bbox_head', 'fc_cls')):
        k = variables['params'][scope][mod]['kernel']
        k[...] = rs.normal(0, 0.3, k.shape)
    # 300 proposals per image (1000 in the configs) keep the CPU's plain
    # RoIAlign short
    jdet.proposal_cfg_test = JProposalConfig(max_per_img=300)
    det = FasterRCNNDetector(num_classes=NUM_CLASSES, depth=18,
                             proposal_cfg_test=ProposalConfig(
                                 max_per_img=300))
    net = det.init(seed=0, device='cpu')
    net.load_state_dict(params_from_jax(variables), strict=True)
    return jdet, variables, det, net


# --------------------------------------------------------------- coder
def test_delta_coder_matches_jax():
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 500, (300, 2))
    anchors = np.concatenate([xy, xy + rs.uniform(4, 300, (300, 2))],
                             -1).astype(np.float32)
    gxy = xy + rs.normal(0, 20, (300, 2))
    gt = np.concatenate([gxy, gxy + rs.uniform(4, 300, (300, 2))],
                        -1).astype(np.float32)
    deltas = (rs.randn(300, 4) * 2).astype(np.float32)
    deltas[:20, 2:] = rs.choice([-9.0, 9.0], (20, 2))  # wh_ratio_clip
    shape = np.asarray([480.0, 640.0], np.float32)
    for stds in ((1., 1., 1., 1.), (0.1, 0.1, 0.2, 0.2)):
        jc = JCoder(target_stds=stds)
        tc = DeltaXYWHBBoxCoder(target_stds=stds)
        np.testing.assert_allclose(
            tc.encode(torch.from_numpy(anchors),
                      torch.from_numpy(gt)).numpy(),
            np.asarray(jc.encode(jnp.asarray(anchors), jnp.asarray(gt))),
            rtol=1e-6, atol=1e-6)
        for max_shape in (None, shape):
            want = np.asarray(jc.decode(jnp.asarray(anchors),
                                        jnp.asarray(deltas),
                                        max_shape=None if max_shape is None
                                        else jnp.asarray(max_shape)))
            got = tc.decode(torch.from_numpy(anchors),
                            torch.from_numpy(deltas),
                            max_shape=None if max_shape is None
                            else torch.from_numpy(max_shape)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError):
        DeltaXYWHBBoxCoder(add_ctr_clamp=True)


def test_rpn_anchors_match_jax_ratio_major():
    ctx = AnchorContext.build(CANVAS, rpn_anchor_generator())
    jctx = JAnchorContext.build(CANVAS, j_rpn_anchor_generator())
    assert ctx.featmap_sizes == tuple(jctx.featmap_sizes)
    assert ctx.num_level_anchors == tuple(jctx.num_level_anchors)
    np.testing.assert_array_equal(ctx.anchors, jctx.anchors)
    # cell (0, 0) of P2 holds ratios 0.5, 1, 2 in that order (h / w)
    a = ctx.anchors[:3]
    hw = (a[:, 3] - a[:, 1]) / (a[:, 2] - a[:, 0])
    np.testing.assert_allclose(hw, [0.5, 1.0, 2.0], rtol=1e-6)
    # the next cell is shifted by one stride in x
    np.testing.assert_array_equal(ctx.anchors[3:6, ::2],
                                  ctx.anchors[:3, ::2] + 4)


# ------------------------------------------------------- layers (ROADMAP)
@pytest.mark.parametrize('src,dst', [((13, 21), (25, 42)),
                                     ((25, 42), (50, 84)),
                                     ((50, 84), (100, 168)),
                                     ((4, 5), (7, 10)), ((7, 9), (13, 17)),
                                     ((3, 5), (8, 11))])
def test_nearest_upsample_matches_jax(src, dst):
    """The FPN's top-down resize at P2-P6 sizes and at non-integer ratios:
    the same index rule (floor(i * in / out) in float32) as erd_tpu and as
    torch's F.interpolate(mode='nearest')."""
    x = np.random.RandomState(0).randn(1, *src, 3).astype(np.float32)
    want = np.asarray(j_upsample(jnp.asarray(x), dst))
    got = nearest_upsample_to(nchw(x), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    ref = torch.nn.functional.interpolate(nchw(x), size=dst, mode='nearest')
    np.testing.assert_array_equal(got, ref.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize('hw', [(25, 42), (13, 21), (7, 10)])
def test_explicit_padding_matches_jax(hw):
    """Stride-2 3x3 conv (padding k // 2 each side) and the stem's
    3x3/2 max-pool (padding 1) on odd and even sizes."""
    import flax.linen as fnn
    rs = np.random.RandomState(1)
    x = rs.randn(1, *hw, 4).astype(np.float32)
    conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding=[torch_pad(3)] * 2)
    params = to_numpy(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    tconv = Conv2d(4, 5, 3, stride=2)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            params['params']['kernel'].transpose(3, 2, 0, 1))))
        tconv.bias.copy_(torch.from_numpy(params['params']['bias']))
        got = tconv(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(j_max_pool(jnp.asarray(x), 3, 2, 1))
    got = max_pool_torch(nchw(x), 3, 2, 1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ RoIAlign
def edge_rois(h, w, stride):
    """Off-image, degenerate, zero (a padded proposal slot) and
    last-row/column boxes, in image coordinates of a (h, w) level."""
    H, W = h * stride, w * stride
    return np.asarray([
        [-50, -40, -5, -2], [W + 3, 0, W + 90, 40],      # off the image
        [10, 10, 10, 10], [0, 0, 0, 0], [30, 5, 29, 60],  # degenerate
        [W - 2 * stride, H - 2 * stride, W + stride, H + stride],
        [W - stride, 0, W, H], [0, H - stride, W, H],     # last col / row
        [-stride, -stride, 3 * stride, 2 * stride],       # clamped at 0
    ], np.float32)


def random_rois(rs, n, H, W, max_size=None):
    xy = rs.uniform(-20, [W, H], (n, 2))
    wh = np.exp(rs.uniform(np.log(4), np.log(max_size or max(H, W)),
                           (n, 2)))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize('stride', [1, 4, 16])
def test_roi_align_level_matches_jax(stride):
    rs = np.random.RandomState(stride)
    h, w = 20, 24
    feat = rs.randn(h, w, 8).astype(np.float32)
    rois = np.concatenate([random_rois(rs, 40, h * stride, w * stride),
                           edge_rois(h, w, stride)])
    want = np.asarray(j_roi_align(jnp.asarray(feat), jnp.asarray(rois), 7,
                                  1.0 / stride, 2)).transpose(0, 3, 1, 2)
    got = roi_align_level(torch.from_numpy(feat).permute(2, 0, 1),
                          torch.from_numpy(rois), 1.0 / stride).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(feat).max())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_multilevel_roi_align_matches_jax(dtype):
    """Both images of a batch, all four levels, random and edge-case RoIs;
    bf16 maps are read as they are by the port and widened by erd_tpu."""
    rs = np.random.RandomState(3)
    sizes = [(32, 40), (16, 20), (8, 10), (4, 5)]
    feats = [rs.randn(2, h, w, 8).astype(np.float32) for h, w in sizes]
    if dtype == 'bfloat16':
        feats = [np.asarray(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32))
                 for f in feats]
    rois = np.stack([np.concatenate([
        random_rois(rs, 120, *CANVAS, max_size=900), edge_rois(32, 40, 4),
        edge_rois(4, 5, 32)]) for _ in range(2)])
    jlvl = np.asarray(jax.vmap(lambda r: j_map_roi_levels(r, 4))(
        jnp.asarray(rois)))
    levels = map_roi_levels(torch.from_numpy(rois), 4)
    diff = np.nonzero(levels.numpy() != jlvl)
    assert diff[0].size == 0, f'RoIs on another level: {rois[diff]}'
    assert set(np.unique(jlvl)) == {0, 1, 2, 3}
    want = np.asarray(jax.vmap(lambda f0, f1, f2, f3, r: j_multilevel(
        [f0, f1, f2, f3], r))(*[jnp.asarray(f) for f in feats],
                              jnp.asarray(rois))).transpose(0, 1, 4, 2, 3)
    tfeats = [nchw(f).to(getattr(torch, dtype)) for f in feats]
    got = multilevel_roi_align(tfeats, torch.from_numpy(rois), STRIDES)
    assert got.dtype == torch.float32 and got.shape == (2, rois.shape[1],
                                                        8, 7, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * max(np.abs(f).max()
                                               for f in feats))
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(got, roi_align_plain(tfeats, torch.from_numpy(rois),
                                            levels, STRIDES))
    assert torch.equal(got, roi_align(tfeats, torch.from_numpy(rois),
                                      levels, STRIDES))


# ------------------------------------------------------------ soft-NMS
def soft_nms_case(rs, k, num_labels=5):
    centres = rs.uniform(40, 600, (6, 2))
    c = centres[rs.randint(6, size=k)] + rs.normal(0, 12, (k, 2))
    wh = rs.uniform(16, 120, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rs.uniform(0.05, 1.0, k).astype(np.float32)
    labels = rs.randint(0, num_labels, k).astype(np.int32)
    valid = rs.rand(k) > 0.15
    return boxes, scores, labels, valid


@pytest.mark.parametrize('method,masked,agnostic,k', [
    ('linear', False, False, 300), ('linear', True, False, 300),
    ('linear', True, True, 300), ('gaussian', False, False, 300),
    ('gaussian', True, True, 300), ('linear', True, False, 60)])
def test_soft_nms_matches_jax(method, masked, agnostic, k):
    """Class-aware and class-agnostic, with and without a valid mask; K=60
    has fewer candidates than max_out and pads."""
    rs = np.random.RandomState(k + len(method))
    boxes, scores, labels, valid = soft_nms_case(rs, k)
    kw = dict(iou_threshold=0.5, sigma=0.5, min_score=1e-3, method=method,
              class_agnostic=agnostic)
    want = jax.jit(lambda b, s, lab, v: j_soft_nms_select(
        b, s, lab, 100, valid_mask=v, **kw))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        jnp.asarray(valid) if masked else None)
    got = soft_nms_select(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(labels).long(), 100,
                          valid_mask=torch.from_numpy(valid) if masked
                          else None, **kw)
    wb, ws, wl, wm = (np.asarray(a) for a in want)
    assert got[3].shape == (100,) and wm.sum() > 30
    np.testing.assert_array_equal(got[3].numpy(), wm)
    np.testing.assert_array_equal(got[2].numpy(), wl)
    np.testing.assert_array_equal(got[0].numpy(), wb)
    np.testing.assert_allclose(got[1].numpy(), ws, atol=0,
                               rtol=1e-6 if method == 'linear' else 1e-5)
    if method == 'linear':
        assert (got[1].numpy() < scores.max()).any()  # something decayed


def test_soft_nms_batch_and_config_match_jax():
    """nms_select_cfg carries the soft-NMS settings; a batch of two images
    gives each image's own result."""
    from erd_tpu.ops.nms import nms_select_cfg as j_cfg
    from erd_tpu_torch.ops import nms_select_cfg
    rs = np.random.RandomState(9)
    cases = [soft_nms_case(rs, 200) for _ in range(2)]
    cfg = dict(nms_type='soft_nms', iou_threshold=0.4, max_per_img=50,
               soft_nms_method='gaussian', soft_nms_sigma=0.3,
               soft_nms_min_score=0.05)
    got = nms_select_cfg(*(torch.from_numpy(np.stack([c[i] for c in cases]))
                           for i in range(3)), GFLTestConfig(**cfg),
                         valid_mask=torch.from_numpy(
                             np.stack([c[3] for c in cases])))
    for i, (boxes, scores, labels, valid) in enumerate(cases):
        want = jax.jit(lambda b, s, lab, v: j_cfg(
            b, s, lab, JTestConfig(**cfg), valid_mask=v))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
            jnp.asarray(valid))
        np.testing.assert_array_equal(got[3][i].numpy(), np.asarray(want[3]))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=0)  # gaussian


# ------------------------------------------------------ RPN proposals
def test_rpn_proposals_match_jax():
    """Identical RPN outputs: objectness on a 1/64 grid, so equal logits
    are exact ties on both sides and the sigmoids' last-bit differences
    cannot reorder candidates."""
    rs = np.random.RandomState(4)
    ctx = AnchorContext.build(CANVAS, rpn_anchor_generator())
    jctx = JAnchorContext.build(CANVAS, j_rpn_anchor_generator())
    cls, reg = [], []
    for h, w in ctx.featmap_sizes:
        cls.append(np.round(rs.normal(0, 2, (2, h, w, 3)) * 64).astype(
            np.float32) / 64)
        reg.append((rs.randn(2, h, w, 12) * 0.5).astype(np.float32))
    jmeta, meta = metas()
    cfg = dict(nms_pre=100, max_per_img=300)
    want = jax.jit(lambda c, r, s: j_rpn_proposals(
        jctx, c, r, s, JCoder(), JProposalConfig(**cfg)))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
        jmeta.img_shape)
    got = rpn_proposals(ctx, [torch.from_numpy(c) for c in cls],
                        [torch.from_numpy(r) for r in reg], meta.img_shape,
                        DeltaXYWHBBoxCoder(), ProposalConfig(**cfg))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 100 < got[2].sum() < 600  # some slots are padding
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-4)


# -------------------------------------------------------- bbox head
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bbox_head_matches_jax(frcnn, dtype):
    """Shared2FC on the same RoI features: erd_tpu flattens (7, 7, C), the
    port (C, 7, 7) with shared_fcs.0's rows permuted on import. bf16: the
    weights rounded to bf16, float32 features and products on both sides
    (flax's Dense promotes the bf16 parameters to the float32 input)."""
    jdet, variables, _, _ = frcnn
    rs = np.random.RandomState(5)
    feats = rs.randn(30, 7, 7, 256).astype(np.float32)
    jdtype = getattr(jnp, dtype)
    jcls, jreg = jdet.net.apply(cast_compute_params(variables, jdtype),
                                jnp.asarray(feats), method='roi_forward')
    assert jcls.dtype == jnp.float32  # flax promotes to the input's dtype
    det = FasterRCNNDetector(num_classes=NUM_CLASSES, depth=18,
                             compute_dtype=getattr(torch, dtype))
    net = det.init(seed=1, device='cpu')
    net.load_state_dict(params_from_jax(variables), strict=True)
    cls, reg = det.roi_forward(net, nchw(feats)[None])
    for g, w in ((cls[0], jcls), (reg[0], jreg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


# --------------------------------------------------- R-CNN predict
def head_case(rs, r=200):
    """Head outputs for two images: logits on a 1/64 grid, real-looking
    proposals with a few padded (masked, zero) slots."""
    cls = np.round(rs.normal(0, 1.5, (2, r, NUM_CLASSES + 1)) * 64).astype(
        np.float32) / 64
    reg = (rs.randn(2, r, 4 * NUM_CLASSES) * 0.5).astype(np.float32)
    rois = np.stack([random_rois(rs, r, *CANVAS) for _ in range(2)])
    rois = np.clip(rois, 0, [160, 128, 160, 128]).astype(np.float32)
    mask = rs.rand(2, r) > 0.1
    rois[~mask] = 0.0
    return cls, reg, rois, mask


@pytest.mark.parametrize('nms_type', ['nms', 'soft_nms'])
def test_rcnn_predict_matches_jax(nms_type):
    rs = np.random.RandomState(6)
    cls, reg, rois, mask = head_case(rs)
    jmeta, meta = metas()
    cfg = dict(score_thr=0.05, iou_threshold=0.5, max_per_img=60,
               pre_nms_total=300, nms_type=nms_type)
    jcoder = JCoder(target_stds=(0.1, 0.1, 0.2, 0.2))
    want = jax.jit(jax.vmap(lambda c, g, r, m, s, f: j_rcnn(
        c, g, r, m, s, f, NUM_CLASSES, jcoder, JTestConfig(**cfg))))(
        jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(rois),
        jnp.asarray(mask), jmeta.img_shape, jmeta.scale_factor)
    got = rcnn_predict(torch.from_numpy(cls), torch.from_numpy(reg),
                       torch.from_numpy(rois), torch.from_numpy(mask), meta,
                       NUM_CLASSES,
                       DeltaXYWHBBoxCoder(target_stds=(0.1, 0.1, 0.2, 0.2)),
                       GFLTestConfig(**cfg))
    wb, ws, wl, wm = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got.mask.numpy(), wm)
    assert got.mask.sum() > 60
    assert (got.num_candidates.numpy() == 300).all()
    np.testing.assert_array_equal(got.labels.numpy(), wl)
    np.testing.assert_allclose(got.scores.numpy(), ws, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), wb, rtol=0, atol=1e-4)


# ------------------------------------------------------- whole predict
@pytest.mark.parametrize('nms_type', ['nms', 'soft_nms'])
def test_faster_rcnn_predict_matches_jax(frcnn, nms_type):
    """The network against erd_tpu's (1e-4 * max|out|); then the port's
    predict after the network, fed erd_tpu's FPN levels and RPN outputs,
    against erd_tpu's predict: every stage after the network runs in the
    port (proposals with the NMS, RoIAlign, the head, the per-class decode
    and hard or soft NMS)."""
    jdet, variables, det, net = frcnn
    cfg = dict(iou_threshold=0.5, nms_type=nms_type)
    jdet.test_cfg = JTestConfig(**cfg)
    det.test_cfg = GFLTestConfig(**cfg)
    images = np.random.RandomState(7).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    jmeta, meta = metas()

    (jrpn_cls, jrpn_reg), jhead = jdet.forward_jit(variables,
                                                   jnp.asarray(images))
    (rpn_cls, rpn_reg), head = det.forward_raw(net, torch.from_numpy(images))
    for g, w in zip(list(rpn_cls) + list(rpn_reg) + list(head),
                    list(jrpn_cls) + list(jrpn_reg) + list(jhead)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())

    # a fresh jit: the test config is read when predict is traced
    want = jax.jit(jdet.predict)(variables, dict(images=jnp.asarray(images),
                                                 meta=jmeta))
    feats = jdet.net.apply(variables,
                           jdet.preprocessor(jnp.asarray(images)),
                           method='extract_feat')
    got = det.predict_from_feats(
        net, CANVAS, [nchw(f) for f in feats],
        [torch.from_numpy(np.array(c)) for c in jrpn_cls],
        [torch.from_numpy(np.array(r)) for r in jrpn_reg], meta)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.sum() > 50
    assert (got.num_candidates.numpy() > 100).all()
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=0, atol=1e-2)
    if nms_type == 'nms':  # the port's own predict, end to end
        own = det.predict(net, dict(images=torch.from_numpy(images),
                                    meta=meta))
        assert own.bboxes.shape == (2, 100, 4) and own.mask.sum() > 50
        assert torch.isfinite(own.bboxes).all()


def test_state_dict_has_mmdet_names(frcnn):
    """The neck, RPN and R-CNN head keys of mmdet's Faster R-CNN R50-FPN
    checkpoints, with their shapes (4 classes here)."""
    state = frcnn[3].state_dict()
    heads = {k: tuple(v.shape) for k, v in state.items()
             if not k.startswith('backbone.')}
    want = {}
    for i, c in enumerate((64, 128, 256, 512)):  # ResNet-18's C2-C5
        want[f'neck.lateral_convs.{i}.conv.weight'] = (256, c, 1, 1)
        want[f'neck.lateral_convs.{i}.conv.bias'] = (256,)
        want[f'neck.fpn_convs.{i}.conv.weight'] = (256, 256, 3, 3)
        want[f'neck.fpn_convs.{i}.conv.bias'] = (256,)
    for name, shape in (('rpn_conv', (256, 256, 3, 3)),
                        ('rpn_cls', (3, 256, 1, 1)),
                        ('rpn_reg', (12, 256, 1, 1))):
        want[f'rpn_head.{name}.weight'] = shape
        want[f'rpn_head.{name}.bias'] = shape[:1]
    for name, shape in (('shared_fcs.0', (1024, 12544)),
                        ('shared_fcs.1', (1024, 1024)),
                        ('fc_cls', (NUM_CLASSES + 1, 1024)),
                        ('fc_reg', (4 * NUM_CLASSES, 1024))):
        want[f'roi_head.bbox_head.{name}.weight'] = shape
        want[f'roi_head.bbox_head.{name}.bias'] = shape[:1]
    assert heads == want


def test_faster_rcnn_loss_and_other_two_stage_types_raise(frcnn):
    """The loss is ported (tests/test_torch_frcnn_train.py); its OHEM
    sampler, which erd_tpu also offers, and the other two-stage types still
    raise."""
    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    _, _, det, net = frcnn
    with pytest.raises(NotImplementedError,
                       match='"Zoo, after the main path"'):
        build_detector(Config(type='FasterRCNN',
                              train_cfg=dict(rcnn_sampler='ohem')))
    for mtype in ('MaskRCNN', 'CascadeRCNN'):
        with pytest.raises(NotImplementedError,
                           match='"Zoo, after the main path"'):
            build_detector(Config(type=mtype))
