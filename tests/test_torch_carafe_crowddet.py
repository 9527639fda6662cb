"""Port parity: FPN-CARAFE Faster R-CNN and CrowdDet serving vs erd_tpu, on
the CPU.

Weights come from erd_tpu's own initialisation (through its config builder)
via ``params_from_jax``; inputs are made with numpy from seeds, on a 1/64
grid where ties or exact sums matter. erd_tpu initialises every CARAFE
``content_encoder`` to N(0, 0.001), which gives every tap a weight near
1/25, so the tests give those kernels and biases seeded values on both
sides. Tolerances, each with its reason:
- the CARAFE weights (pixel shuffle + softmax): 1e-6 absolute, exp differs
  from XLA's by an ulp;
- the reassembly in float32: 1e-5 * max|x|, XLA's einsum sums the 25 taps
  in its own order (with FMAs), the port in tap order;
- the reassembly in bf16: one bf16 ulp, a float32 sum that differs in the
  last bit can round to the neighbouring bf16 value;
- CARAFEPack and FPNCARAFE in float32: 1e-5 * max|out| (measured 4.4e-7
  and 7.8e-7), the convolutions' sums in another order as well; in bf16:
  3e-2 * max|out| (measured 1.1e-2 and 6.9e-3), bf16 conv outputs that
  differ by an ulp move the softmax weights and round the map anew;
- set-NMS: keep masks exactly;
- the multi-instance head: 1e-5 * max|out| (float32 products summed in
  another order);
- the networks: 1e-4 * max|out|, as tests/test_torch_frcnn.py (erd_tpu's
  space-to-depth stem reassociates the stem's sums);
- predict and inference_detector from identical network outputs: masks,
  labels and keep decisions exactly, scores 1e-5, boxes 1e-2 px;
- soft-NMS above the kernel's shared-memory limit: selections exactly,
  linear scores 1e-6.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.apis.build import build_detector as j_build_detector
from erd_tpu.config import Config as JConfig
from erd_tpu.models.layers import cast_compute_params
from erd_tpu.models.necks.pyramid_extras import FPNCARAFE as JFPNCARAFE
from erd_tpu.ops.carafe import CARAFEPack as JCARAFEPack
from erd_tpu.ops.carafe import carafe_reassemble as j_reassemble
from erd_tpu.ops.nms import nms_mask as j_nms_mask
from erd_tpu.ops.nms import set_nms_mask as j_set_nms_mask
from erd_tpu.ops.nms import soft_nms_select as j_soft_nms_select
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector, inference_detector
from erd_tpu_torch.config import Config
from erd_tpu_torch.models import CrowdDetDetector, FasterRCNNDetector
from erd_tpu_torch.models.heads import ProposalConfig
from erd_tpu_torch.models.necks import FPN, FPNCARAFE
from erd_tpu_torch.models.weight_import import (load_torch_checkpoint_file,
                                                 params_from_jax)
from erd_tpu_torch.ops import (CARAFEPack, arrange_carafe, carafe,
                               carafe_plain, carafe_weights, set_nms_mask,
                               set_nms_sorted_keep, set_nms_sorted_keep_plain,
                               soft_nms_select)
from erd_tpu_torch.structures import ImageMeta, stack_to

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'carafe': os.path.join(ROOT, 'configs', 'carafe',
                           'faster_rcnn_r50_fpn_carafe_1x_coco.py'),
    'crowddet': os.path.join(ROOT, 'configs', 'crowddet',
                             'crowddet-rcnn_r50_fpn_8xb2-30e_crowdhuman.py')}
CANVAS = (128, 160)


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, 1)))


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def grid(rs, shape, std=1.0):
    """N(0, std^2) values on a 1/64 grid."""
    return (np.round(rs.normal(0, std, shape) * 64) / 64).astype(np.float32)


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in bf16 ulps."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return (key(a) - key(b)).abs()


def assert_close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def arranged_carafe(tree, rs):
    """erd_tpu params with every ``content_encoder`` kernel N(0, (0.5 /
    sqrt(fan_in))^2) and bias N(0, 2.5^2), seeded, in tree order."""
    out = {}
    for k, v in tree.items():
        if k == 'content_encoder':
            fan_in = int(np.prod(v['kernel'].shape[:3]))
            out[k] = {'kernel': rs.normal(0, 0.5 / fan_in ** 0.5,
                                          v['kernel'].shape).astype(
                                              np.float32),
                      'bias': rs.normal(0, 2.5, v['bias'].shape).astype(
                          np.float32)}
        elif isinstance(v, dict):
            out[k] = arranged_carafe(v, rs)
        else:
            out[k] = v
    return out


# ------------------------------------------------------------- CARAFE op
def j_carafe_pack_tail(x, logits):
    """erd_tpu/ops/carafe.py:58-68 on NHWC x and logits (both of x's
    dtype): pixel shuffle, float32 softmax, reassembly, cast back."""
    b, h, w, _ = logits.shape
    lg = logits.reshape(b, h, w, 2, 2, 25).transpose(0, 1, 3, 2, 4, 5)
    kernels = jax.nn.softmax(lg.reshape(b, h * 2, w * 2, 25).astype(
        jnp.float32), axis=-1)
    out = jax.vmap(lambda xi, ki: j_reassemble(xi.astype(jnp.float32), ki))(
        x, kernels)
    return kernels, out.astype(x.dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('hw', [(7, 9), (5, 12), (1, 3)])
def test_carafe_plain_matches_reassemble(dtype, hw):
    """Non-uniform logits (N(0, 2^2)), odd sizes; the weights and the
    reassembly against erd_tpu's."""
    rs = np.random.RandomState(hw[0] * 31 + hw[1])
    tdtype = getattr(torch, dtype)
    x = torch.from_numpy(grid(rs, (2, *hw, 16), 1.5)).to(tdtype)
    logits = torch.from_numpy(grid(rs, (2, *hw, 100), 2.0)).to(tdtype)
    jdtype = getattr(jnp, dtype)
    jk, jout = jax.jit(j_carafe_pack_tail)(
        jnp.asarray(x.float().numpy(), jdtype),
        jnp.asarray(logits.float().numpy(), jdtype))
    xt, lt = x.permute(0, 3, 1, 2).contiguous(), \
        logits.permute(0, 3, 1, 2).contiguous()
    weights = carafe_weights(lt)
    np.testing.assert_allclose(nhwc(weights), np.asarray(jk), rtol=0,
                               atol=1e-6)
    assert float(weights.amax(1).mean()) > 0.2  # peaked, not 1/25
    got = carafe_plain(xt, lt)
    assert got.dtype == tdtype and got.shape == (2, 16, 2 * hw[0], 2 * hw[1])
    want = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    if dtype == 'bfloat16':
        assert int(bf16_ulps(got.permute(0, 2, 3, 1),
                             want.to(torch.bfloat16)).max()) <= 1
    else:
        np.testing.assert_allclose(nhwc(got), want.numpy(), rtol=0,
                                   atol=1e-5 * float(x.abs().max()))


def carafe_pack_pair(rs, channels, x_shape):
    """erd_tpu's CARAFEPack with arranged content_encoder and the port's
    with the same weights, mapped by params_from_jax."""
    jmod = JCARAFEPack(channels)
    variables = to_numpy(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                            jnp.zeros(x_shape)))
    params = arranged_carafe(variables['params'], rs)
    state = params_from_jax({'params': {'neck': {'chain0': {
        'carafe_1': params}}}})
    prefix = 'neck.upsample_modules.0.'
    mod = CARAFEPack(channels)
    mod.load_state_dict({k[len(prefix):]: v for k, v in state.items()},
                        strict=True)
    return jmod, {'params': params}, mod


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_carafe_pack_matches_jax(dtype):
    rs = np.random.RandomState(3)
    x = grid(rs, (2, 7, 9, 32))
    jmod, variables, mod = carafe_pack_pair(rs, 32, x.shape)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(jmod.apply)(cast_compute_params(variables, jdtype),
                               jnp.asarray(x, jdtype))
    with torch.no_grad():
        got = mod(nchw(x).to(tdtype))
    assert got.dtype == tdtype and got.shape == (2, 32, 14, 18)
    assert_close(got.permute(0, 2, 3, 1),
                 np.asarray(want.astype(jnp.float32)),
                 3e-2 if dtype == 'bfloat16' else 1e-5)


# -------------------------------------------------------------- the neck
SIZES = [(13, 19), (7, 10), (4, 5), (2, 3)]  # every top-down step crops


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fpn_carafe_matches_jax(dtype):
    """Odd level sizes: CARAFE doubles 2x3 to 4x6, cropped to 4x5; 4x5 to
    8x10, cropped to 7x10; 7x10 to 14x20, cropped to 13x19."""
    rs = np.random.RandomState(5)
    in_ch = (16, 24, 32, 48)
    feats = [grid(rs, (1, h, w, c)) for (h, w), c in zip(SIZES, in_ch)]
    jneck = JFPNCARAFE(in_channels=in_ch, out_channels=32)
    variables = to_numpy(jax.jit(jneck.init)(
        jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats]))
    params = arranged_carafe(variables['params'], rs)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(jneck.apply)(
        cast_compute_params({'params': params}, jdtype),
        [jnp.asarray(f, jdtype) for f in feats])
    neck = FPNCARAFE(in_channels=in_ch, out_channels=32).eval()
    state = params_from_jax({'params': {'neck': {'chain0': params}}})
    neck.load_state_dict({k[len('neck.'):]: v for k, v in state.items()},
                         strict=True)
    with torch.no_grad():
        got = neck([nchw(f).to(tdtype) for f in feats])
    assert [tuple(g.shape[2:]) for g in got] == SIZES + [(1, 2)]
    for g, w in zip(got, want):
        assert g.dtype == tdtype
        assert_close(g.permute(0, 2, 3, 1), np.asarray(w.astype(jnp.float32)),
                     3e-2 if dtype == 'bfloat16' else 1e-5)


# --------------------------------------------------------------- set-NMS
def set_nms_case(rs, k, pairs=True):
    """Clustered boxes; each proposal's two instances nearly coincide (the
    CrowdDet case); scores on a 1/64 grid with ties; 10 % invalid."""
    centres = rs.uniform(20, 300, (5, 2))
    n = k // 2 if pairs else k
    c = centres[rs.randint(5, size=n)] + rs.normal(0, 8, (n, 2))
    wh = rs.uniform(20, 80, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    if pairs:
        boxes = np.repeat(boxes, 2, 0) + rs.normal(0, 1.5, (k, 4))
        groups = np.arange(k) // 2
    else:
        groups = rs.randint(0, k // 3, k)
    scores = (rs.randint(0, 40, k) / 64).astype(np.float32)
    valid = rs.rand(k) > 0.1
    return (boxes.astype(np.float32), scores, groups.astype(np.int64), valid)


@pytest.mark.parametrize('pairs', [True, False])
@pytest.mark.parametrize('masked', [True, False])
def test_set_nms_mask_matches_jax(pairs, masked):
    rs = np.random.RandomState(int(pairs) * 2 + int(masked))
    boxes, scores, groups, valid = set_nms_case(rs, 400, pairs)
    if not masked:
        scores = np.where(valid, scores, -np.inf).astype(np.float32)
    want = np.asarray(jax.jit(lambda b, s, g, v: j_set_nms_mask(
        b, s, g, 0.5, valid_mask=v))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(groups),
        jnp.asarray(valid) if masked else None))
    args = [torch.from_numpy(a) for a in (boxes, scores, groups)]
    got = set_nms_mask(*args, 0.5, valid_mask=torch.from_numpy(valid)
                       if masked else None)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()
    assert not want[~valid].any()
    # the group test acts: plain NMS keeps fewer of the same boxes (random
    # groups rarely share an overlapping pair)
    plain = np.asarray(j_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                  0.5, jnp.asarray(valid)))
    assert want.sum() > plain.sum() if pairs else want.sum() >= plain.sum()
    # a batch of two gives each image's own mask
    batch = set_nms_mask(*[torch.stack([a, a.flip(0)]) for a in args], 0.5,
                         valid_mask=torch.from_numpy(np.stack(
                             [valid, valid[::-1]])))
    assert torch.equal(batch[0], got if masked else set_nms_mask(
        *args, 0.5, valid_mask=torch.from_numpy(valid)))


def test_set_nms_one_group_keeps_every_valid_box():
    rs = np.random.RandomState(9)
    boxes, scores, _, valid = set_nms_case(rs, 60)
    got = set_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.zeros(60, dtype=torch.int64), 0.5,
                       valid_mask=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), valid)


# ------------------------------------------------------ detector fixtures
def small_cfg(config_cls, kind):
    cfg = config_cls.fromfile(CONFIGS[kind])
    cfg.model.depth = 18
    cfg.model.compute_dtype = 'float32'
    if kind == 'carafe':
        cfg.model.num_classes = 4
    return cfg


@pytest.fixture(scope='module')
def models():
    """Per config: erd_tpu's detector and variables, and the port's with
    the same weights. BN statistics and biases perturbed; the RPN
    objectness and the class kernels widened to N(0, 0.3), so that scores
    spread and near-ties stay rare; CARAFE's content encoders arranged."""
    cache = {}

    def get(kind):
        if kind in cache:
            return cache[kind]
        jdet = j_build_detector(small_cfg(JConfig, kind).model)
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
        p = variables['params']
        cls = ['fc_cls_0', 'fc_cls_1'] if kind == 'crowddet' else ['fc_cls']
        for scope, mod in [('rpn_head', 'rpn_cls')] + \
                [('bbox_head', c) for c in cls]:
            k = p[scope][mod]['kernel']
            k[...] = rs.normal(0, 0.3, k.shape)
        variables['params'] = arranged_carafe(p, rs)
        jdet.proposal_cfg_test = type(jdet.proposal_cfg_test)(
            max_per_img=300)  # 1000 in the configs: keeps RoIAlign short
        det = build_detector(small_cfg(Config, kind).model)
        det.proposal_cfg_test = ProposalConfig(max_per_img=300)
        net = det.build_net().eval()
        net.load_state_dict(params_from_jax(variables), strict=True)
        cache[kind] = (jdet, variables, det, net)
        return cache[kind]
    return get


def metas():
    pairs = [((120, 150), (240, 300), (0.5, 0.5)),
             ((128, 144), (128, 144), (1.0, 1.0))]
    j = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                     *[JImageMeta.make(*p) for p in pairs])
    return j, stack_to([ImageMeta.make(*p) for p in pairs], 'cpu')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_multi_instance_head_matches_jax(models, dtype):
    """CrowdDet's head on the same RoI features: two (C+1)-way classifiers
    and two 4-delta regressors off the shared trunk, shared_fcs.0's rows
    permuted on import; bf16 rounds the weights, products in float32."""
    jdet, variables, _, _ = models('crowddet')
    feats = np.random.RandomState(5).randn(30, 7, 7, 256).astype(np.float32)
    jcls, jreg = jdet.net.apply(cast_compute_params(
        variables, getattr(jnp, dtype)), jnp.asarray(feats),
        method='roi_forward')
    det = build_detector(small_cfg(Config, 'crowddet').model)
    det.compute_dtype = getattr(torch, dtype)
    net = det.build_net()
    net.load_state_dict(params_from_jax(variables), strict=True)
    cls, reg = det.roi_forward(net, nchw(feats)[None])
    assert cls.shape == (1, 30, 2, 2) and reg.shape == (1, 30, 2, 4)
    assert_close(cls[0], jcls, 1e-5)
    assert_close(reg[0], jreg, 1e-5)


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_predict_matches_jax(models, kind):
    """The float32 network against erd_tpu's (1e-4 * max|out|); then the
    port's predict after the network, fed erd_tpu's FPN levels and RPN
    outputs, against erd_tpu's predict: proposals, RoIAlign, the head and
    the post-processing (set-NMS for CrowdDet) all run in the port."""
    jdet, variables, det, net = models(kind)
    images = np.random.RandomState(7).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    jmeta, meta = metas()
    (jrpn_cls, jrpn_reg), jhead = jdet.forward_jit(variables,
                                                   jnp.asarray(images))
    (rpn_cls, rpn_reg), head = det.forward_raw(net, torch.from_numpy(images))
    for g, w in zip(list(rpn_cls) + list(rpn_reg) + list(head),
                    list(jrpn_cls) + list(jrpn_reg) + list(jhead)):
        assert tuple(g.shape) == np.asarray(w).shape
        assert_close(g, w, 1e-4)
    want = jax.jit(jdet.predict)(variables, dict(images=jnp.asarray(images),
                                                 meta=jmeta))
    feats = jdet.net.apply(variables, jdet.preprocessor(jnp.asarray(images)),
                           method='extract_feat')
    got = det.predict_from_feats(
        net, CANVAS, [nchw(f) for f in feats],
        [torch.from_numpy(np.array(c)) for c in jrpn_cls],
        [torch.from_numpy(np.array(r)) for r in jrpn_reg], meta)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.sum() > 50
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    ok = got.mask.numpy()  # CrowdDet leaves its empty slots' boxes as is
    np.testing.assert_allclose(got.bboxes.numpy()[ok],
                               np.asarray(want.bboxes)[ok], rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_inference_detector_matches_jax(models, kind, monkeypatch):
    """The user's entry point on images of the canvas size (no resize, no
    rescale), the network's first stage taken from erd_tpu (the network is
    held against erd_tpu's above), against erd_tpu's predict."""
    jdet, variables, det, net = models(kind)
    images = np.random.RandomState(8).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    want = jax.jit(jdet.predict)(variables, dict(
        images=jnp.asarray(images), meta=jax.tree.map(
            lambda *xs: jnp.asarray(np.stack(xs)),
            *[JImageMeta.make(CANVAS, CANVAS, (1.0, 1.0))] * 2)))
    calls = []

    def jax_first_stage(net_, imgs):
        i = len(calls)
        calls.append(i)
        jimg = jnp.asarray(imgs.numpy())
        feats, jcls, jreg = jdet._feats_and_rpn(variables, jimg)
        assert np.array_equal(imgs.numpy()[0], images[i])
        return ([nchw(f) for f in feats],
                [torch.from_numpy(np.array(c)) for c in jcls],
                [torch.from_numpy(np.array(r)) for r in jreg])
    monkeypatch.setattr(det, 'feats_and_rpn', jax_first_stage)
    res = inference_detector(det, net, list(images), scale=CANVAS[::-1])
    assert len(calls) == 2
    for i, r in enumerate(res):
        m = np.asarray(want.mask[i])
        assert len(r.scores) == m.sum() > 20
        np.testing.assert_array_equal(r.labels, np.asarray(want.labels[i])[m])
        np.testing.assert_allclose(r.scores, np.asarray(want.scores[i])[m],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(r.bboxes, np.asarray(want.bboxes[i])[m],
                                   rtol=0, atol=1e-2)


# --------------------------------------------------------------- weights
@pytest.mark.parametrize('kind', list(CONFIGS))
def test_params_from_jax_is_one_to_one(models, kind):
    """Every erd_tpu leaf becomes one distinct port tensor, loaded strictly
    and handed back unchanged; the new scopes land on mmdet's names."""
    _, variables, det, net = models(kind)
    state = params_from_jax(variables)
    assert len(state) == len(jax.tree.leaves(variables))
    for k, v in net.state_dict().items():
        assert torch.equal(v, state[k]), k
    p = variables['params']
    if kind == 'carafe':
        neck = p['neck']['chain0']
        np.testing.assert_array_equal(
            state['neck.upsample_modules.2.content_encoder.weight'].numpy(),
            neck['carafe_3']['content_encoder']['kernel'].transpose(
                3, 2, 0, 1))
        np.testing.assert_array_equal(
            state['neck.lateral_convs.0.conv.bias'].numpy(),
            neck['lateral_0']['bias'])
        assert isinstance(net.neck, FPNCARAFE)
    else:
        np.testing.assert_array_equal(
            state['roi_head.bbox_head.fc_cls.1.weight'].numpy(),
            p['bbox_head']['fc_cls_1']['kernel'].T)
        np.testing.assert_array_equal(
            state['roi_head.bbox_head.fc_reg.0.bias'].numpy(),
            p['bbox_head']['fc_reg_0']['bias'])
        assert isinstance(net.neck, FPN)


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_full_size_state_dict_matches_erd_tpu_shapes(kind):
    """Both configs at full width and depth: the port's state_dict has
    exactly the keys and shapes of params_from_jax of erd_tpu's variables,
    from jax.eval_shape (no forward)."""
    jdet = j_build_detector(JConfig.fromfile(CONFIGS[kind]).model)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0),
                                              image_shape=(64, 64)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}
    det = build_detector(Config.fromfile(CONFIGS[kind]).model)
    got = {k: tuple(v.shape) for k, v in det.build_net().state_dict().items()}
    assert got == want
    if kind == 'carafe':
        assert got['neck.upsample_modules.0.channel_compressor.weight'] == \
            (64, 256, 1, 1)
        assert got['neck.upsample_modules.0.content_encoder.weight'] == \
            (100, 64, 3, 3)
    else:
        assert got['roi_head.bbox_head.fc_cls.0.weight'] == (2, 1024)
        assert got['roi_head.bbox_head.fc_reg.1.weight'] == (4, 1024)


def test_checkpoint_files(models, tmp_path):
    """CrowdDet loads an mmdet-style file by name; the CARAFE neck raises,
    naming mmcv's content_encoder order."""
    _, _, _, net = models('crowddet')
    gen = torch.Generator().manual_seed(0)
    state = {f'module.{k}': torch.randn(v.shape, generator=gen)
             if v.is_floating_point() else v
             for k, v in net.state_dict().items()}
    path = tmp_path / 'crowddet.pth'
    torch.save({'state_dict': state}, path)
    fresh = build_detector(small_cfg(Config, 'crowddet').model).build_net()
    load_torch_checkpoint_file(fresh, str(path))
    assert torch.equal(fresh.roi_head.bbox_head.fc_cls[1].weight,
                       state['module.roi_head.bbox_head.fc_cls.1.weight'])
    cnet = build_detector(small_cfg(Config, 'carafe').model).build_net()
    with pytest.raises(NotImplementedError, match='content_encoder'):
        load_torch_checkpoint_file(cnet, str(path))


# --------------------------------------------------- builder and raises
def test_build_detector_accepts_and_raises():
    det = build_detector(Config.fromfile(CONFIGS['carafe']).model)
    assert type(det) is FasterRCNNDetector and det.num_classes == 80
    assert det.neck == dict(type='FPN_CARAFE', out_channels=256, num_outs=5,
                            start_level=0)
    assert det.compute_dtype == torch.bfloat16
    assert det.test_cfg.iou_threshold == 0.5
    crowd = build_detector(Config.fromfile(CONFIGS['crowddet']).model)
    assert type(crowd) is CrowdDetDetector and crowd.num_classes == 1
    assert crowd.test_cfg.iou_threshold == 0.5  # outside the GFL family
    assert crowd.test_cfg.pre_nms_total == 2000
    assert build_detector(Config(type='CrowdDet')).test_cfg.iou_threshold \
        == 0.5
    # the loss is ported (tests/test_torch_carafe_crowddet_train.py); the
    # OHEM sampler is not
    with pytest.raises(NotImplementedError, match='rcnn_sampler'):
        build_detector(Config(type='CrowdDet',
                              train_cfg=dict(rcnn_sampler='ohem')))
    carafe_neck = dict(type='FPN_CARAFE', out_channels=256, num_outs=5,
                       start_level=0)
    for model in (dict(type='GFL', neck=carafe_neck),
                  dict(type='CrowdDet', neck=carafe_neck),
                  dict(type='FasterRCNN', neck=dict(type='PAFPN')),
                  dict(type='FasterRCNN', neck=[carafe_neck, carafe_neck])):
        with pytest.raises(NotImplementedError, match='not ported yet'):
            build_detector(Config(**model))
    chained = build_detector(Config(type='FasterRCNN', neck=[carafe_neck]))
    assert chained.neck == carafe_neck


# ----------------------------------------------- soft-NMS at a large K
def test_soft_nms_plain_above_kernel_limit_matches_jax():
    """K = 12000 candidates, above the ~9600 that the kernel's shared-memory
    variant holds on an H100: the wrapper's CPU path (the plain scan)
    against erd_tpu's, linear decay, 100 steps."""
    rs = np.random.RandomState(12)
    k = 12000
    xy = rs.uniform(0, 1200, (k, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(10, 150, (k, 2))],
                           -1).astype(np.float32)
    scores = rs.uniform(0.05, 1.0, k).astype(np.float32)
    labels = rs.randint(0, 5, k)
    valid = rs.rand(k) > 0.05
    kw = dict(iou_threshold=0.5, sigma=0.5, min_score=1e-3, method='linear')
    want = jax.jit(lambda b, s, lab, v: j_soft_nms_select(
        b, s, lab, 100, valid_mask=v, **kw))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        jnp.asarray(valid))
    got = soft_nms_select(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(labels), 100,
                          valid_mask=torch.from_numpy(valid), **kw)
    wb, ws, wl, wm = (np.asarray(a) for a in want)
    assert wm.sum() == 100
    np.testing.assert_array_equal(got[3].numpy(), wm)
    np.testing.assert_array_equal(got[2].numpy(), wl)
    np.testing.assert_array_equal(got[0].numpy(), wb)
    np.testing.assert_allclose(got[1].numpy(), ws, rtol=1e-6, atol=0)


# ------------------------------------------- the wrappers' CPU paths
def test_new_wrappers_take_plain_only_on_cpu():
    """On CPU tensors carafe and set-NMS run their plain versions and
    launch nothing; a device without a kernel raises (no fallback)."""
    rs = np.random.RandomState(13)
    x = torch.from_numpy(grid(rs, (1, 8, 5, 6)))
    logits = torch.from_numpy(grid(rs, (1, 100, 5, 6)))
    before = carafe.launches
    assert torch.equal(carafe(x, logits), carafe_plain(x, logits))
    assert carafe.launches == before
    boxes, scores, groups, valid = set_nms_case(rs, 50)
    order = torch.from_numpy(np.argsort(-scores, kind='stable').copy())
    args = (torch.from_numpy(boxes)[order].contiguous(),
            torch.from_numpy(valid)[order].contiguous(),
            torch.from_numpy(groups)[order].contiguous(), order)
    before = set_nms_sorted_keep.launches
    b = [a[None] for a in args]
    assert torch.equal(set_nms_sorted_keep(*b, 0.5),
                       set_nms_sorted_keep_plain(*b, 0.5))
    assert set_nms_sorted_keep.launches == before
    meta = torch.device('meta')
    with pytest.raises(RuntimeError, match='no kernel'):
        carafe(x.to(meta), logits.to(meta))
    with pytest.raises(RuntimeError, match='no kernel'):
        set_nms_sorted_keep(*[a.to(meta) for a in b], 0.5)
    with pytest.raises(ValueError, match='do not fit'):
        carafe(x, logits[:, :99])


def test_arrange_carafe_peaks_the_taps():
    """arrange_carafe's seeded content encoders: the largest tap weight
    averages well above 1/25, and the four sub-pixel kernels differ."""
    neck = FPNCARAFE(in_channels=(8, 8, 8, 8), out_channels=16)
    arrange_carafe(neck, seed=3)
    x = torch.from_numpy(grid(np.random.RandomState(4), (1, 16, 6, 7)))
    with torch.no_grad():
        mod = neck.upsample_modules[0]
        logits = mod.content_encoder(mod.channel_compressor(x))
    w = carafe_weights(logits)
    assert float(w.amax(1).mean()) >= 0.2
    sub = w.view(1, 25, 6, 2, 7, 2)
    assert not torch.equal(sub[:, :, :, 0, :, 0], sub[:, :, :, 1, :, 1])


# -------------------------------------------- float32 conv precision
@pytest.mark.parametrize('stride,bias', [(1, True), (2, False)])
def test_ieee_conv_matches_conv2d_forward_and_backward(stride, bias):
    """conv2d_ieee (the port's float32 convs, whose backward also runs in
    full float32 on the card) gives F.conv2d's output and gradients; on the
    CPU the same kernels, so exactly."""
    import torch.nn.functional as F

    from erd_tpu_torch.utils import conv2d_ieee, conv_fp32_precision
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 6, 9, 11, generator=gen)
    w = torch.randn(5, 6, 3, 3, generator=gen)
    b = torch.randn(5, generator=gen) if bias else None
    r = torch.randn(2, 5, (9 - 1) // stride + 1, (11 - 1) // stride + 1,
                    generator=gen)
    outs = []
    for fn in (conv2d_ieee, F.conv2d):
        leaves = [t.clone().requires_grad_(True) for t in (x, w)] + \
            ([b.clone().requires_grad_(True)] if bias else [])
        out = fn(leaves[0], leaves[1], leaves[2] if bias else None,
                 (stride, stride), (1, 1))
        (out * r).sum().backward()
        outs.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match='ieee'):
        with conv_fp32_precision('highest'):
            pass
