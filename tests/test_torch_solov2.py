"""Port parity: SOLOv2 serving vs erd_tpu, float32 on the CPU.

The network is SOLOv2 on ResNet-18 with narrow heads (mask features 32 ->
64 channels, head 64 channels, 64-d dynamic kernels), 8 classes, two
128x160 images: erd_tpu's own modules (``MaskFeatureHead``,
``SOLOV2HeadNet``, ResNet, FPN) at those widths, initialised by flax and
carried across with ``params_from_jax``. erd_tpu's init scores every cell
near the 0.01 prior, under ``score_thr``, and puts the dynamic masks'
logits near 0: ``arranged`` sets ``conv_cls``'s bias to -4.5 and scales
its kernel by 4 and ``conv_kernel``'s by 3, the same on both sides, so
that a few hundred cells pass and the mask logits spread beyond +-2.

Tolerances, each with its reason:
- resizes: 1e-6 * max|x| (the same triangle weights, summed in another
  order); the coordinate channels exactly in bf16 and within 1.2e-7 in
  float32 (XLA folds the 1 / (n - 1) division into a product);
- the heads and the network's outputs: 1e-4 * max|out| (convolutions
  summed in another order, ~20 layers);
- predict: the network's outputs differ by ~1e-5 relative, so a mask pixel
  whose logit sits within that of 0 flips, and a cell whose probability
  sits within it of ``score_thr`` may enter or leave; each flip moves its
  detection's area, maskness and decayed score. The test counts them: the
  detections are matched by (label, box) and at least 95 % of erd_tpu's
  match one of the port's, with scores within 1e-4 relative and crops
  within 1e-4; the differing mask pixels of the matched detections are
  at most 0.1 % of their pixels.
"""
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from erd_tpu.models.backbones.resnet import ResNet as JResNet
from erd_tpu.models.detectors import solov2 as J
from erd_tpu.models.necks.fpn import FPN as JFPN
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import (build_detector, build_trainer,
                                inference_detector, init_detector)
from erd_tpu_torch.config import Config
from erd_tpu_torch.models import SOLOV2Detector
from erd_tpu_torch.models.detectors import solov2 as P
from erd_tpu_torch.models.weight_import import (load_torch_checkpoint_file,
                                                 params_from_jax)
from erd_tpu_torch.ops import matrix_decay
from erd_tpu_torch.structures import ImageMeta, stack_to

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs', 'solov2',
                      'solov2_r50_fpn_1x_coco.py')
NC, FC, MO, HC = 8, 32, 64, 64
CANVAS = (128, 160)


class NarrowSOLOV2Net(fnn.Module):
    """erd_tpu's SOLOV2Net on ResNet-18 with narrow heads."""
    num_classes: int

    @fnn.compact
    def __call__(self, images):
        feats = JResNet(depth=18, compute_dtype=jnp.float32,
                        name='backbone')(images)
        feats = JFPN(in_channels=tuple(f.shape[-1] for f in feats),
                     out_channels=256, start_level=0, add_extra_convs='',
                     num_outs=5, name='neck')(feats)
        masks = J.MaskFeatureHead(feat_channels=FC, out_channels=MO,
                                  name='mask_feature_head')(feats[:4])
        kernels, cls = J.SOLOV2HeadNet(
            num_classes=self.num_classes, feat_channels=HC, kernel_out=MO,
            name='mask_head')(feats)
        return kernels, cls, masks.astype(jnp.float32)


def narrow_port_net(det):
    net = det.build_net()
    net.mask_feature_head = P.MaskFeatureHead(feat_channels=FC,
                                              out_channels=MO)
    net.mask_head = P.SOLOV2HeadNet(NC, feat_channels=HC, kernel_out=MO)
    return net


def arranged(variables):
    """conv_cls bias -4.5, its kernel x 4, conv_kernel's x 3 (numpy, in
    place); GN scales and biases perturbed so that the norms do work."""
    head = variables['params']['mask_head']
    head['conv_cls']['bias'][...] = -4.5
    head['conv_cls']['kernel'][...] *= 4.0
    head['conv_kernel']['kernel'][...] *= 3.0
    rs = np.random.RandomState(0)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = [getattr(p, 'key', None) for p in path]
        if 'gn' in keys and keys[-1] == 'scale':
            leaf[...] = rs.uniform(0.5, 1.5, leaf.shape)
        elif 'gn' in keys and keys[-1] == 'bias':
            leaf[...] = rs.normal(0, 0.1, leaf.shape)
    return variables


def metas():
    """Two images in the 128x160 canvas, the first one rescaled."""
    pairs = [((120, 150), (240, 300), (0.5, 0.5)),
             ((128, 160), (128, 160), (1.0, 1.0))]
    j = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                     *[JImageMeta.make(*p) for p in pairs])
    return j, stack_to([ImageMeta.make(*p) for p in pairs], 'cpu')


@pytest.fixture(scope='module')
def solo():
    jdet = J.SOLOV2Detector(num_classes=NC, depth=18)
    jdet.net = NarrowSOLOV2Net(num_classes=NC)
    variables = arranged(jax.tree.map(
        lambda x: np.array(x, np.float32),
        jdet.init(jax.random.PRNGKey(0), image_shape=CANVAS)))
    det = SOLOV2Detector(num_classes=NC, depth=18)
    net = narrow_port_net(det)
    net.load_state_dict(params_from_jax(variables), strict=True)
    images = np.random.RandomState(2).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    return jdet, variables, det, net.eval(), images


def assert_close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


# ------------------------------------------------------- resize, coords
@pytest.mark.parametrize('src,dst', [
    ((200, 336), (100, 168)),  # level 0 halved at 800x1344
    ((100, 168), (40, 40)), ((100, 168), (36, 36)), ((50, 84), (24, 24)),
    ((25, 42), (16, 16)), ((25, 42), (12, 12)),  # the grids: shrink
    ((13, 21), (25, 42)),  # level 4 grown to level 3
    ((16, 20), (40, 40)), ((4, 5), (12, 12)), ((2, 3), (4, 5)),  # grow
    ((50, 30), (36, 36)), ((20, 9), (16, 16))])  # mixed: one axis each way
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(sum(src)).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                       'bilinear'))
    got = P._resize(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    assert_close(got.permute(0, 2, 3, 1), want, 1e-6)


@pytest.mark.parametrize('hw', [(12, 12), (40, 40), (25, 42), (100, 168),
                                (4, 5), (1, 3)])
def test_coord_channels_match_jnp_linspace(hw):
    h, w = hw
    for jd, td, tol in ((jnp.float32, torch.float32, 1.2e-7),
                        (jnp.bfloat16, torch.bfloat16, 0.0)):
        want = np.asarray(J._coord_channels(h, w, jd).astype(jnp.float32))
        got = P._coord_channels(h, w, td, 'cpu').float().permute(1, 2, 0)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# ------------------------------------------------------------ the heads
def test_mask_feature_head_and_head_net_match_flax():
    """Both heads at narrow widths on seeded P2-P6 features of a 128x160
    canvas (the grids grow from every level there), GN perturbed."""
    rs = np.random.RandomState(3)
    feats = [rs.randn(2, 32 // 2 ** i, 40 // 2 ** i, 256).astype(np.float32)
             for i in range(4)] + [rs.randn(2, 2, 3, 256).astype(np.float32)]
    jfeats = [jnp.asarray(f) for f in feats]
    mfh = J.MaskFeatureHead(feat_channels=FC, out_channels=MO)
    head = J.SOLOV2HeadNet(num_classes=NC, feat_channels=HC, kernel_out=MO)
    v = {'params': {
        'mask_feature_head': mfh.init(jax.random.PRNGKey(1),
                                      jfeats[:4])['params'],
        'mask_head': head.init(jax.random.PRNGKey(2), jfeats)['params']}}
    v = arranged(jax.tree.map(lambda x: np.array(x, np.float32), v))
    port = nn.Module()
    port.mask_feature_head = P.MaskFeatureHead(feat_channels=FC,
                                               out_channels=MO)
    port.mask_head = P.SOLOV2HeadNet(NC, feat_channels=HC, kernel_out=MO)
    port.load_state_dict(params_from_jax(v), strict=True)
    tfeats = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    with torch.no_grad():
        got_m = port.mask_feature_head(tfeats[:4])
        got_k, got_c = port.mask_head(tfeats)
    want_m = mfh.apply({'params': v['params']['mask_feature_head']},
                       jfeats[:4])
    assert_close(got_m.permute(0, 2, 3, 1), want_m, 1e-4)
    want_k, want_c = head.apply({'params': v['params']['mask_head']},
                                jfeats)
    for g, w in zip(got_k + got_c, want_k + want_c):
        assert_close(g, w, 1e-4)


def test_network_outputs_match_erd_tpu(solo):
    jdet, variables, det, net, images = solo
    jk, jc, jm = jdet.forward_jit(variables, jnp.asarray(images))
    pk, pc, pm = det.forward_raw(net, torch.from_numpy(images))
    for g, w in zip(list(pk) + list(pc), list(jk) + list(jc)):
        assert_close(g, w, 1e-4)
    assert_close(pm.permute(0, 2, 3, 1), jm, 1e-4)


# -------------------------------------------------------------- predict
def match_detections(res_p, crops_p, res_j, crops_j):
    """Per image, erd_tpu's detections matched to the port's by label and
    box (within 1e-3 px): (matched pairs, erd_tpu's count)."""
    pairs, total = [], 0
    for b in range(res_j.mask.shape[0]):
        mj = np.asarray(res_j.mask[b])
        mp = res_p.mask[b].numpy()
        total += int(mj.sum())
        used = set()
        for i in np.flatnonzero(mj):
            for k in np.flatnonzero(mp):
                if k in used or int(res_p.labels[b, k]) != \
                        int(res_j.labels[b, i]):
                    continue
                if np.abs(res_p.bboxes[b, k].numpy() -
                          np.asarray(res_j.bboxes[b, i])).max() <= 1e-3:
                    used.add(k)
                    pairs.append((b, k, i))
                    break
    return pairs, total


def test_predict_matches_erd_tpu_with_tie_flips_bounded(solo):
    jdet, variables, det, net, images = solo
    jmeta, meta = metas()
    res_j, crops_j = jdet.predict_jit(variables, dict(
        images=jnp.asarray(images), meta=jmeta))
    res_p, crops_p = det.predict(net, dict(images=torch.from_numpy(images),
                                           meta=meta))
    assert crops_p.shape == (2, 100, 28, 28)
    n_j = np.asarray(res_j.mask).sum(1)
    assert (n_j >= 20).all(), n_j
    pairs, total = match_detections(res_p, crops_p, res_j, crops_j)
    assert len(pairs) >= 0.95 * total and \
        int(res_p.mask.sum()) <= total + 0.05 * total
    for b, k, i in pairs:
        np.testing.assert_allclose(float(res_p.scores[b, k]),
                                   float(res_j.scores[b, i]), rtol=1e-4)
        assert np.abs(crops_p[b, k].numpy() -
                      np.asarray(crops_j[b, i])).max() <= 1e-4
    flipped = sum(int(((crops_p[b, k].numpy() > 0.5) !=
                       (np.asarray(crops_j[b, i]) > 0.5)).sum())
                  for b, k, i in pairs)
    assert flipped <= 1e-3 * len(pairs) * 28 * 28


def test_predict_runs_matrix_decay_once_a_batch(solo, monkeypatch):
    """The decode's matrix NMS is ``matrix_decay`` on the (B, 500, 500)
    mask IoU: one call a batch, with SOLOv2's sigma and kernel."""
    _, _, det, net, images = solo
    calls = []

    def spy(scores, iou, labels, sigma, kernel):
        calls.append((tuple(scores.shape), tuple(iou.shape), sigma, kernel))
        return matrix_decay(scores, iou, labels, sigma, kernel)
    monkeypatch.setattr(P, 'matrix_decay', spy)
    det.predict(net, dict(images=torch.from_numpy(images), meta=metas()[1]))
    assert calls == [((2, 500), (2, 500, 500), 2.0, 'gaussian')]


# ------------------------------------------- weights, build_detector
def test_params_from_jax_keeps_solov2_scopes_apart_from_mask_rcnns():
    """SOLOv2's ``mask_head`` keeps erd_tpu's names; a two-stage tree's
    ``mask_head`` still maps to Mask R-CNN's ``roi_head.mask_head``."""
    k = np.zeros((3, 3, 4, 8), np.float32)
    solo = params_from_jax({'params': {
        'mask_feature_head': {'conv_pred': {'conv': {'kernel': k}}},
        'mask_head': {'kernel_conv_0': {'conv': {'kernel': k},
                                        'gn': {'scale': np.ones(8)}},
                      'conv_cls': {'kernel': k, 'bias': np.zeros(8)}}}})
    assert set(solo) == {'mask_feature_head.conv_pred.conv.weight',
                         'mask_head.kernel_conv_0.conv.weight',
                         'mask_head.kernel_conv_0.gn.weight',
                         'mask_head.conv_cls.weight',
                         'mask_head.conv_cls.bias'}
    assert solo['mask_head.conv_cls.weight'].shape == (8, 4, 3, 3)
    rcnn = params_from_jax({'params': {
        'rpn_head': {'rpn_conv': {'kernel': k}},
        'mask_head': {'conv_0': {'kernel': k}}}})
    assert 'roi_head.mask_head.convs.0.conv.weight' in rcnn


def test_build_detector_serves_the_config_and_trainer_raises(solo, tmp_path):
    cfg = Config.fromfile(CONFIG)
    det = build_detector(cfg.model)
    assert isinstance(det, SOLOV2Detector)
    assert (det.num_classes, det.depth, det.compute_dtype, det.nms_pre,
            det.score_thr, det.mask_thr, det.filter_thr, det.max_per_img) == \
        (80, 50, torch.bfloat16, 500, 0.1, 0.5, 0.05, 100)
    with pytest.raises(NotImplementedError, match='SOLOv2 training'):
        build_trainer(cfg, det, None)
    with pytest.raises(NotImplementedError, match='SOLOv2 training'):
        det.loss(None, {})
    with pytest.raises(NotImplementedError, match='params_from_jax'):
        load_torch_checkpoint_file(solo[3], str(tmp_path / 'none.pth'))


def test_init_detector_and_inference_detector_on_the_config():
    """The config's R50 SOLOv2 at full width on the CPU (float32), one
    image at a small scale: erd_tpu's init scores no cell over score_thr,
    so no detection; predict gives 100 empty slots and their crops."""
    cfg = Config.fromfile(CONFIG)
    cfg.model.compute_dtype = 'float32'
    det, net, _ = init_detector(cfg, device='cpu')
    assert next(net.parameters()).device.type == 'cpu'
    img = np.random.RandomState(4).randint(0, 256, (100, 140, 3), np.uint8)
    res = inference_detector(det, net, img, scale=(160, 128))
    assert res.bboxes.shape == (0, 4) and len(res.scores) == 0
    canvas = torch.from_numpy(np.zeros((1, 128, 160, 3), np.uint8))
    out, crops = det.predict(net, dict(
        images=canvas, meta=stack_to([ImageMeta.make(
            (128, 160), (128, 160), (1.0, 1.0))], 'cpu')))
    assert out.bboxes.shape == (1, 100, 4) and crops.shape == (1, 100, 28,
                                                               28)
    assert not bool(out.mask.any()) and torch.isfinite(crops).all()
