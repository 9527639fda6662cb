"""Port parity: erd_tpu_torch's deformable convolution, the DCN ResNet, GFL
with DCN stages and VFNet serving vs erd_tpu on the CPU.

Inputs are made with numpy from seeds; weights come from erd_tpu's own
initialisation through ``params_from_jax``. erd_tpu initialises every
``conv_offset`` to zero, which samples integer pixels only with mask 0.5, so
the tests replace those kernels and biases on both sides with seeded values
(``arranged``). Tolerances, each with its reason:
- the columns (plain gather) against erd_tpu's ``_bilinear_zero`` patches:
  1e-6 * max|x|, the same float32 ops (0.0 unless XLA contracts a multiply
  and an add);
- ``deform_conv2d`` in float32: 2e-6 * max|out| (measured 1.6e-7); the
  port's product sums the (Cin, K*K) rows in another order than erd_tpu's
  (K*K, Cin) patches;
- ``ModulatedDeformConv``: float32 1e-5 * max|out| (measured 4.2e-7; also
  the offset conv and the sigmoid, whose last bits differ between XLA and
  torch); bf16 one bf16 ulp of max|out| (2**-8 * max|out|; measured 0.0):
  a float32 sum that differs in the last bit can round to the
  neighbouring bf16 value;
- the DCN ResNet and the networks in float32: 1e-4 * max|out|, as the GFL
  network test (erd_tpu's space-to-depth stem reassociates the 7x7 sums);
- the VFNet head on identical maps: float32 1e-5 * max|out| (measured
  1.6e-6); bf16 2e-2 * max|out| (measured 3.7e-3: bf16 roundings that
  differ by an ulp move the offsets and what follows them);
- predict: the masks and labels exactly, scores 1e-5, boxes 1e-2 px.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from erd_tpu.apis.build import build_detector as j_build_detector
from erd_tpu.config import Config as JConfig
from erd_tpu.models.backbones.resnet import ResNet as JResNet
from erd_tpu.models.heads.gfl_head import GFLTestConfig as JTestConfig
from erd_tpu.models.heads.vfnet_head import VFNetContext as JVFNetContext
from erd_tpu.models.heads.vfnet_head import VFNetHeadNet as JVFNetHead
from erd_tpu.models.heads.vfnet_head import star_offsets as j_star_offsets
from erd_tpu.models.heads.vfnet_head import vfnet_predict as j_vfnet_predict
from erd_tpu.models.layers import cast_compute_params
from erd_tpu.ops.deform_conv import ModulatedDeformConv as JModulatedDCN
from erd_tpu.ops.deform_conv import _bilinear_zero
from erd_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector
from erd_tpu_torch.config import Config
from erd_tpu_torch.models import GFLDetector, GFLTestConfig, VFNetDetector
from erd_tpu_torch.models.backbones import ResNet
from erd_tpu_torch.models.heads import (VFNetContext, VFNetHeadNet,
                                        star_offsets, vfnet_predict)
from erd_tpu_torch.models.weight_import import (load_torch_checkpoint_file,
                                                 params_from_jax)
from erd_tpu_torch.ops import (ModulatedDeformConv, deform_conv2d,
                               deform_im2col, deform_im2col_plain)
from erd_tpu_torch.structures import GTInstances, ImageMeta, stack_to

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, 'configs')
GFL_DCN_CFG = os.path.join(CONFIGS, 'dcn',
                           'gfl_r50_fpn_dconv_c3-c5_1x_coco.py')
GFL_R101_CFG = os.path.join(CONFIGS, 'gfl',
                            'gfl_r101_dconv_c3-c5_fpn_ms2x_coco.py')
VFNET_CFG = os.path.join(CONFIGS, 'vfnet',
                         'vfnet_r50_mdconv_c3_c5_fpn_ms2x_coco.py')
NUM_CLASSES = 4
IMAGE = (64, 96)  # tests/test_vfnet.py's size


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def arranged(variables, seed):
    """erd_tpu variables with every ``conv_offset`` kernel N(0, (0.05 /
    sqrt(fan_in))^2) and bias N(0, 1.5^2), seeded, in tree order."""
    rs = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if k == 'conv_offset':
                fan_in = int(np.prod(v['kernel'].shape[:3]))
                out[k] = {'kernel': rs.normal(
                    0, 0.05 / fan_in ** 0.5,
                    v['kernel'].shape).astype(np.float32),
                    'bias': rs.normal(0, 1.5,
                                      v['bias'].shape).astype(np.float32)}
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out
    return {c: walk(t) if c == 'params' else t for c, t in variables.items()}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def offsets_nchw(offset):
    """erd_tpu's (B, Ho, Wo, dg, K*K, 2) -> the port's (B, dg*K*K*2, Ho,
    Wo)."""
    b, ho, wo = offset.shape[:3]
    return nchw(offset.reshape(b, ho, wo, -1))


def assert_close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def dcn_case(rs, b=2, h=7, w=8, cin=4, dg=1, stride=1, k=3, scale=1.5):
    ho = (h + 2 - k) // stride + 1
    wo = (w + 2 - k) // stride + 1
    x = rs.randn(b, h, w, cin).astype(np.float32)
    offset = (rs.randn(b, ho, wo, dg, k * k, 2) * scale).astype(np.float32)
    mask = rs.rand(b, ho, wo, dg, k * k).astype(np.float32)
    return x, offset, mask


@pytest.mark.parametrize('dg', [1, 2])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('use_mask', [True, False])
def test_deform_conv2d_matches_jax(dg, stride, use_mask):
    rs = np.random.RandomState(dg * 10 + stride)
    x, offset, mask = dcn_case(rs, dg=dg, stride=stride)
    mask = mask if use_mask else None
    weight = rs.randn(3, 3, 4, 5).astype(np.float32)
    want = jax.vmap(lambda xi, oi, mi: j_deform_conv2d(
        xi, oi, jnp.asarray(weight), mi, stride=stride, deform_groups=dg))(
        jnp.asarray(x), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask))
    got = deform_conv2d(
        nchw(x), offsets_nchw(offset),
        torch.from_numpy(weight).permute(3, 2, 0, 1),
        None if mask is None else nchw(mask.reshape(*mask.shape[:3], -1)),
        stride=stride, deform_groups=dg)
    assert_close(got.permute(0, 2, 3, 1), want, 2e-6)


@pytest.mark.parametrize('dg,stride', [(1, 1), (2, 2)])
def test_columns_match_jax_bilinear(dg, stride):
    """The gather alone: the port's columns against erd_tpu's per-group
    ``_bilinear_zero`` patches times the mask."""
    rs = np.random.RandomState(7)
    x, offset, mask = dcn_case(rs, b=1, h=9, w=11, cin=6, dg=dg,
                               stride=stride, scale=2.5)
    ho, wo = offset.shape[1:3]
    oy = np.arange(ho) * stride - 1
    ox = np.arange(wo) * stride - 1
    ky, kx = np.meshgrid(np.arange(3), np.arange(3), indexing='ij')
    base_y = oy[:, None, None] + ky.reshape(-1)[None, None]
    base_x = ox[None, :, None] + kx.reshape(-1)[None, None]
    gch = 6 // dg
    parts = []
    for g in range(dg):
        samp = _bilinear_zero(jnp.asarray(x[0, ..., g * gch:(g + 1) * gch]),
                              base_y + offset[0, :, :, g, :, 0],
                              base_x + offset[0, :, :, g, :, 1])
        parts.append(np.asarray(samp * mask[0, :, :, g, :, None]))
    want = np.concatenate(parts, -1)  # (Ho, Wo, K*K, Cin)
    want = want.transpose(3, 2, 0, 1).reshape(6 * 9, ho * wo)
    got = deform_im2col(nchw(x), offsets_nchw(offset),
                        nchw(mask.reshape(1, ho, wo, -1)), 3, stride, 1, 1,
                        dg)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize('groups', [2, 4])
def test_grouped_deform_conv_matches_jax(groups):
    rs = np.random.RandomState(groups)
    x, offset, mask = dcn_case(rs, cin=8)
    weight = rs.randn(3, 3, 8 // groups, 8).astype(np.float32)
    want = jax.vmap(lambda xi, oi, mi: j_deform_conv2d(
        xi, oi, jnp.asarray(weight), mi, conv_groups=groups))(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask))
    got = deform_conv2d(nchw(x), offsets_nchw(offset),
                        torch.from_numpy(weight).permute(3, 2, 0, 1),
                        nchw(mask.reshape(*mask.shape[:3], -1)),
                        conv_groups=groups)
    assert_close(got.permute(0, 2, 3, 1), want, 2e-6)


@pytest.mark.parametrize('stride', [1, 2])
def test_zero_offsets_equal_conv2d(stride):
    """Offsets 0, no mask: a plain 3x3 convolution."""
    rs = np.random.RandomState(stride)
    x = torch.from_numpy(rs.randn(2, 6, 9, 10).astype(np.float32))
    w = torch.from_numpy(rs.randn(4, 6, 3, 3).astype(np.float32))
    ho, wo = (9 - 1) // stride + 1, (10 - 1) // stride + 1
    got = deform_conv2d(x, torch.zeros(2, 18, ho, wo), w, stride=stride)
    want = F.conv2d(x, w, stride=stride, padding=1)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_border_exact_offsets_match_jax():
    """Samples exactly on rows / columns -1, 0, H-1 and H (floor of an
    exact integer, y0 + 1 == H), and a hair inside and outside them."""
    rs = np.random.RandomState(5)
    h, w = 6, 7
    x = rs.randn(1, h, w, 3).astype(np.float32)
    ys = np.array([-1, 0, h - 1, h, -1.0001, h - 1.0001, -0.9999, h + 0.5],
                  np.float32)
    xs = np.array([-1, 0, w - 1, w, w - 0.9999, -1.0001, w - 1.0001, 0.25],
                  np.float32)
    ty, tx = np.meshgrid(ys, xs, indexing='ij')
    # every output pixel and kernel point aims at one of the targets
    oy = np.arange(h)[:, None, None] - 1 + np.repeat(np.arange(3), 3)
    ox = np.arange(w)[None, :, None] - 1 + np.tile(np.arange(3), 3)
    pick = rs.randint(0, ty.size, (h, w, 9))
    offset = np.stack([ty.reshape(-1)[pick] - oy, tx.reshape(-1)[pick] - ox],
                      -1).astype(np.float32)[None, :, :, None]
    weight = rs.randn(3, 3, 3, 2).astype(np.float32)
    want = j_deform_conv2d(jnp.asarray(x[0]), jnp.asarray(offset[0]),
                           jnp.asarray(weight))
    got = deform_conv2d(nchw(x), offsets_nchw(offset),
                        torch.from_numpy(weight).permute(3, 2, 0, 1))
    assert_close(got[0].permute(1, 2, 0), want, 2e-6)


def j_dcn_module(x, modulated, seed):
    mod = JModulatedDCN(features=8, strides=2, modulated=modulated)
    variables = to_numpy(mod.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    return mod, arranged(variables, seed)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('modulated', [True, False])
def test_modulated_deform_conv_matches_jax(dtype, modulated):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 9, 12, 16).astype(np.float32)
    mod, variables = j_dcn_module(x, modulated, 4)
    jdtype = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    want = mod.apply(cast_compute_params(variables, jdtype),
                     jnp.asarray(x, jdtype))
    p = variables['params']
    net = ModulatedDeformConv(16, 8, stride=2, modulated=modulated)
    net.load_state_dict({
        'weight': torch.from_numpy(p['kernel']).permute(3, 2, 0, 1),
        'conv_offset.weight': torch.from_numpy(
            p['conv_offset']['kernel']).permute(3, 2, 0, 1),
        'conv_offset.bias': torch.from_numpy(p['conv_offset']['bias'])})
    with torch.no_grad():
        got = net(nchw(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got.permute(0, 2, 3, 1),
                 np.asarray(want.astype(jnp.float32)),
                 2 ** -8 if dtype == 'bfloat16' else 1e-5)


def j_detector(path, seed, cls_bias):
    """erd_tpu's detector of a config (4 classes, float32) and its seeded
    variables, conv_offset arranged and the class bias zeroed (scores near
    0.5, so that many candidates reach the NMS)."""
    jdet = j_build_detector(small_cfg(JConfig, path).model)
    variables = arranged(to_numpy(jdet.init(jax.random.PRNGKey(seed),
                                            image_shape=IMAGE)), seed + 3)
    head = variables['params']['bbox_head'][cls_bias]
    head['bias'] = np.zeros_like(head['bias'])
    return jdet, variables


@pytest.fixture(scope='module')
def gfl_dcn():
    return j_detector(GFL_DCN_CFG, 0, 'gfl_cls')


@pytest.fixture(scope='module')
def vfnet_dcn():
    return j_detector(VFNET_CFG, 1, 'vfnet_cls')


@pytest.mark.parametrize('modulated', [True, False])
def test_dcn_resnet_matches_jax(modulated, gfl_dcn, vfnet_dcn):
    """ResNet-50 with DCNv2 (VFNet's config) or DCNv1 (GFL's) in C3-C5."""
    x = np.random.RandomState(1).randn(1, *IMAGE, 3).astype(np.float32)
    jnet = JResNet(depth=50, dcn_stages=(False, True, True, True),
                   dcn_modulated=modulated)
    variables = (vfnet_dcn if modulated else gfl_dcn)[1]
    variables = {c: t['backbone'] for c, t in variables.items()}
    want = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    net = ResNet(50, dcn_stages=(False, True, True, True),
                 dcn_modulated=modulated)
    state = {k[len('backbone.'):]: v for k, v in params_from_jax(
        {c: {'backbone': t} for c, t in variables.items()}).items()}
    net.load_state_dict(state, strict=True)
    assert isinstance(net.layer3[5].conv2, ModulatedDeformConv)
    assert not isinstance(net.layer1[0].conv2, ModulatedDeformConv)
    with torch.no_grad():
        got = net.eval()(nchw(x))
    for g, w in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1), w, 1e-4)


def image_batch(rs, b=1):
    imgs = rs.randint(0, 256, (b, *IMAGE, 3)).astype(np.uint8)
    metas = [JImageMeta.make(IMAGE, (IMAGE[0] * 2, IMAGE[1] * 2), (0.5, 0.5))
             for _ in range(b)]
    jmeta = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *metas)
    pmetas = [ImageMeta(**{f: np.asarray(getattr(m, f)) for f in
                           ('img_shape', 'ori_shape', 'scale_factor', 'flip',
                            'img_id', 'valid')}) for m in metas]
    return (dict(images=jnp.asarray(imgs), meta=jmeta),
            dict(images=torch.from_numpy(imgs),
                 meta=stack_to(pmetas, 'cpu')))


def small_cfg(config_cls, path):
    cfg = config_cls.fromfile(path)
    cfg.model.num_classes = NUM_CLASSES
    cfg.model.compute_dtype = 'float32'
    cfg.model.test_cfg.score_thr = 0.3
    return cfg


def assert_same_detections(got, want):
    """Equal masks; every detection of erd_tpu matched by one of the port's
    with its label, its score within 1e-5 and its box within 1e-2 px. The
    scores sit near 0.5 and near-ties may come out in either order."""
    mask = np.asarray(want.mask)
    assert 5 < mask.sum() and (~mask).sum() > 0
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    g_lab, g_sc, g_box = (got.labels.numpy(), got.scores.numpy(),
                          got.bboxes.numpy())
    w_lab, w_sc, w_box = (np.asarray(want.labels), np.asarray(want.scores),
                          np.asarray(want.bboxes))
    free = got.mask.numpy().copy()
    for b, i in zip(*np.nonzero(mask)):
        match = ((g_lab[b] == w_lab[b, i]) & free[b] &
                 (np.abs(g_sc[b] - w_sc[b, i]) <= 1e-5) &
                 (np.abs(g_box[b] - w_box[b, i]).max(-1) <= 1e-2))
        assert match.any(), (b, i, w_lab[b, i], w_sc[b, i], w_box[b, i])
        free[b, np.argmax(match)] = False  # each detection matches once


def test_gfl_dcn_predict_matches_jax(gfl_dcn):
    """GFL R50 with DCNv1 in C3-C5, through its config, float32."""
    jdet, variables = gfl_dcn
    det = build_detector(small_cfg(Config, GFL_DCN_CFG).model)
    assert isinstance(det, GFLDetector) and det.dcn_modulated is False
    assert det.dcn_stages == (False, True, True, True)
    jbatch, batch = image_batch(np.random.RandomState(4))
    want = jdet.predict_jit(variables, jbatch)
    net = det.build_net().eval()
    net.load_state_dict(params_from_jax(variables), strict=True)
    got = det.predict(net, batch)
    assert_same_detections(got, want)


def test_vfnet_predict_matches_jax(vfnet_dcn):
    """VFNet R50 with DCNv2 in C3-C5 and the star-DCN head, through the
    mdconv config, float32."""
    jdet, variables = vfnet_dcn
    det = build_detector(small_cfg(Config, VFNET_CFG).model)
    assert isinstance(det, VFNetDetector) and det.dcn_modulated is True
    jbatch, batch = image_batch(np.random.RandomState(6))
    want = jdet.predict_jit(variables, jbatch)
    net = det.build_net().eval()
    net.load_state_dict(params_from_jax(variables), strict=True)
    assert_same_detections(det.predict(net, batch), want)


def j_head(feats, seed=0):
    head = JVFNetHead(num_classes=NUM_CLASSES, feat_channels=32)
    variables = to_numpy(jax.jit(head.init)(jax.random.PRNGKey(seed),
                                            [jnp.asarray(f) for f in feats]))
    return head, variables


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_vfnet_head_matches_jax(dtype):
    rs = np.random.RandomState(8)
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    feats = [rs.randn(1, h, w, 32).astype(np.float32) for h, w in sizes]
    head, variables = j_head(feats)
    jdtype = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    want = jax.jit(head.apply)(cast_compute_params(variables, jdtype),
                               [jnp.asarray(f, jdtype) for f in feats])
    net = VFNetHeadNet(NUM_CLASSES, 32).eval()
    state = params_from_jax({'params': {'bbox_head': variables['params']}})
    net.load_state_dict({k[len('bbox_head.'):]: v for k, v in state.items()},
                        strict=True)
    with torch.no_grad():
        got = net([nchw(f).to(getattr(torch, dtype)) for f in feats])
    rel = 2e-2 if dtype == 'bfloat16' else 1e-5
    for got_l, want_l in zip(got, want):
        for g, w in zip(got_l, want_l):
            assert g.dtype == torch.float32
            assert_close(g, w, rel)


def test_star_offsets_match_jax():
    rs = np.random.RandomState(9)
    bp = np.exp(rs.randn(2, 5, 7, 4)).astype(np.float32) * 64
    for stride in (8, 128):
        want = np.asarray(j_star_offsets(jnp.asarray(bp), stride))
        got = star_offsets(nchw(bp), stride)
        # (B, H, W, 1, 9, 2) vs (B, 18, H, W)
        np.testing.assert_array_equal(
            got.permute(0, 2, 3, 1).numpy(), want.reshape(2, 5, 7, 18))


def test_vfnet_predict_post_processing_matches_jax():
    """Head outputs fed to both post-processings; logits on a 1/64 grid so
    that equal scores are exact ties on both sides."""
    canvas = (128, 192)
    rs = np.random.RandomState(0)
    jctx, ctx = JVFNetContext.build(canvas), VFNetContext.build(canvas)
    np.testing.assert_array_equal(ctx.points, jctx.points)
    assert ctx.num_level_points == tuple(jctx.num_level_points)
    cls, boxes, start = [], [], 0
    for n_l, s in zip(ctx.num_level_points, (8, 16, 32, 64, 128)):
        h, w = -(-canvas[0] // s), -(-canvas[1] // s)
        cls.append(np.round(rs.normal(-1.0, 1.5, (2, h, w, NUM_CLASSES)) *
                            64).astype(np.float32) / 64)
        pts = ctx.points[start:start + n_l].reshape(h, w, 2)
        d = rs.uniform(2, 6 * s, (2, h, w, 4)).astype(np.float32)
        boxes.append(np.concatenate([pts - d[..., :2], pts + d[..., 2:]],
                                    -1).astype(np.float32))
        start += n_l
    metas = [JImageMeta.make((120, 180), (240, 360), (0.5, 0.5)),
             JImageMeta.make((128, 96), (200, 150), (0.64, 0.64))]
    cfg = dict(score_thr=0.05, nms_pre=200, iou_threshold=0.6,
               max_per_img=50, pre_nms_total=400)
    jmeta = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *metas)
    want = jax.jit(lambda c, b, m: j_vfnet_predict(
        jctx, c, b, m, JTestConfig(**cfg), NUM_CLASSES))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in boxes],
        jmeta)
    pmetas = [ImageMeta(**{f: np.asarray(getattr(m, f)) for f in
                           ('img_shape', 'ori_shape', 'scale_factor', 'flip',
                            'img_id', 'valid')}) for m in metas]
    got = vfnet_predict(ctx, [torch.from_numpy(c) for c in cls],
                        [torch.from_numpy(b) for b in boxes],
                        stack_to(pmetas, 'cpu'), GFLTestConfig(**cfg),
                        NUM_CLASSES)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.sum() > 20
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize('path', [GFL_R101_CFG, VFNET_CFG])
def test_full_size_state_dict_matches_erd_tpu_shapes(path):
    """The two configs at full width and depth (R101 has blocks 0-22 in
    layer3): the port's state_dict has exactly the keys and shapes of
    params_from_jax of erd_tpu's variables, from jax.eval_shape (no
    forward)."""
    jdet = j_build_detector(JConfig.fromfile(path).model)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0),
                                              image_shape=(64, 64)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}
    det = build_detector(Config.fromfile(path).model)
    net = det.build_net()
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    assert 'backbone.layer3.22.conv2.conv_offset.weight' in got or \
        'bbox_head.vfnet_cls_dconv.weight' in got
    per_point = 3 if det.dcn_modulated else 2
    assert got['backbone.layer2.0.conv2.conv_offset.weight'] == \
        (9 * per_point, 128, 3, 3)


def test_params_from_jax_round_trip(vfnet_dcn):
    """Every erd_tpu leaf of a DCNv2 VFNet becomes one distinct port tensor,
    the port loads them strictly and hands the same values back."""
    variables = vfnet_dcn[1]
    state = params_from_jax(variables)
    assert len(state) == len(jax.tree.leaves(variables))
    net = build_detector(small_cfg(Config, VFNET_CFG).model).build_net()
    net.load_state_dict(state, strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, state[k]), k
    p = variables['params']
    np.testing.assert_array_equal(
        state['bbox_head.vfnet_cls_dconv.weight'].numpy(),
        p['bbox_head']['cls_dconv_kernel'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state['backbone.layer3.1.conv2.conv_offset.bias'].numpy(),
        p['backbone']['layer3_block1']['conv2']['conv_offset']['bias'])
    assert state['bbox_head.scales_refine.4.scale'].shape == ()


def test_dcn_checkpoint_files(tmp_path):
    """A DCNv1 GFL loads from an mmdet-style file by name; a model with
    modulated DCN raises, naming mmcv's channel layout."""
    cfg = small_cfg(Config, GFL_DCN_CFG)
    net = build_detector(cfg.model).build_net()
    gen = torch.Generator().manual_seed(0)
    state = {f'module.{k}': torch.randn(v.shape, generator=gen)
             if v.is_floating_point() else v
             for k, v in net.state_dict().items()}
    path = tmp_path / 'gfl_dcn.pth'
    torch.save({'state_dict': state}, path)
    load_torch_checkpoint_file(net, str(path))
    assert torch.equal(net.backbone.layer4[2].conv2.conv_offset.weight,
                       state['module.backbone.layer4.2.conv2.conv_offset.'
                             'weight'])
    vnet = build_detector(small_cfg(Config, VFNET_CFG).model).build_net()
    with pytest.raises(NotImplementedError, match='ModulatedDeformConv2dPack'):
        load_torch_checkpoint_file(vnet, str(path))


def test_builds_and_unported_paths():
    gfl = build_detector(Config.fromfile(GFL_R101_CFG).model)
    assert isinstance(gfl, GFLDetector) and gfl.depth == 101
    assert gfl.dcn_stages == (False, True, True, True)
    assert gfl.dcn_modulated is False and gfl.compute_dtype == torch.bfloat16
    vf = build_detector(Config.fromfile(VFNET_CFG).model)
    assert isinstance(vf, VFNetDetector) and vf.dcn_modulated is True
    assert vf.test_cfg.iou_threshold == 0.6 and vf.num_classes == 80
    with pytest.raises(NotImplementedError, match='ROADMAP.md, section 1'):
        build_detector(Config.fromfile(os.path.join(
            ROOT, 'configs/dcnv2/faster_rcnn_r50_mdconv_c3-c5_fpn_1x_coco.py'
        )).model)
    # the name is from before DCN training was ported, when VFNet's loss
    # and a deformable conv that needed a gradient raised: now the loss is
    # a dict of tensors with a graph, and the conv's output has a grad_fn
    cfg = small_cfg(Config, VFNET_CFG)
    vf = build_detector(cfg.model)
    assert vf.frozen_stages == 1
    rs = np.random.RandomState(12)
    _, batch = image_batch(rs, b=2)
    batch['gt'] = stack_to([GTInstances.pad(np.array(
        [[8, 6, 50, 40]], np.float32), [1], 2)] * 2, 'cpu')
    losses = vf.loss(vf.init(seed=0, device='cpu'), batch)
    assert set(losses) == {'loss_cls', 'loss_bbox', 'loss_bbox_rf'}
    assert all(v.grad_fn is not None for v in losses.values())
    m = ModulatedDeformConv(4, 4)
    m.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, 5, 5, requires_grad=True)
    out = m(x)
    assert out.grad_fn is not None
    out.sum().backward()
    assert x.grad is not None and m.conv_offset.weight.grad is not None
    with pytest.raises(RuntimeError, match='no kernel'):
        meta = torch.device('meta')
        deform_im2col(torch.empty(1, 4, 5, 5, device=meta),
                      torch.empty(1, 18, 5, 5, device=meta), None)


def test_plain_im2col_is_the_wrappers_cpu_path():
    rs = np.random.RandomState(11)
    x, offset, mask = dcn_case(rs, b=2, cin=6, dg=2)
    args = (nchw(x), offsets_nchw(offset),
            nchw(mask.reshape(*mask.shape[:3], -1)), 3, 1, 1, 1, 2)
    before = deform_im2col.launches
    assert torch.equal(deform_im2col(*args), deform_im2col_plain(*args))
    assert deform_im2col.launches == before  # the plain path launches none
