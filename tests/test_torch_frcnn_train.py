"""Port parity of Faster R-CNN training on the CPU: the MaxIoU assigner, the
random sampler, the RPN and R-CNN losses, RoIAlign's backward, the loss and
gradients of the whole network against erd_tpu, ``build_trainer`` + ``fit``,
and the gradient rules of the kernel wrappers.

The networks are the configs' at depth 18 in float32 (4 classes), B = 2
images in a 96x128 canvas, erd_tpu's weights carried over by
``params_from_jax`` (BN statistics and biases perturbed, the RPN
objectness and class kernels widened so that scores spread). The samplers'
uniform keys are erd_tpu's own: the ``fold_in`` / ``split`` chain of its
``loss``, drawn here with jax.random and handed to the port's ``draws``.
Tolerances, each with its reason:
- assignment and sampling: exactly equal (the same float32 IoU ops, stable
  top-k ties);
- the RPN and R-CNN losses from identical inputs: rtol 1e-6, and their
  input gradients rtol 1e-5 with atol 1e-6 * max|g| (sums reassociate);
- RoIAlign's backward against jax.vjp: rtol 1e-5 with atol 1e-6 * max|g|
  (the four corners' products and the scatter's sums in another order);
- the loss from identical FPN features: losses rtol 1e-5; gradients in the
  features and every head parameter rtol 1e-4 with atol 1e-5 * max|g| of
  each tensor (the RPN conv and the fc sums reassociate);
- the training proposals: masks exactly, boxes within 1e-2 px, but for a
  pair of adjacent slots swapped at a near-tie of scores (1e-6 relative),
  whose order float noise decides (``use_jax_proposals``); erd_tpu's
  proposals then go on to both samplers;
- the whole network: sample sets exactly equal (boxes within 1e-2 px), the
  loss dict rtol 1e-4 and the gradients rtol 1e-3 with atol 1e-5 * max|g|
  of each tensor, as tests/test_torch_train.py (erd_tpu's space-to-depth
  stem reassociates the stem's sums). The frozen stem and layer1 take no
  gradient in the port (requires_grad=False); erd_tpu masks their updates
  in the optimizer instead.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erd_tpu.models.detectors.crowddet as j_crowddet_module
import erd_tpu.models.detectors.faster_rcnn as j_frcnn_module
from erd_tpu.apis.build import build_detector as j_build_detector
from erd_tpu.config import Config as JConfig
from erd_tpu.losses.smooth_l1 import l1_loss as j_l1_loss
from erd_tpu.losses.smooth_l1 import smooth_l1_loss as j_smooth_l1_loss
from erd_tpu.models.heads.bbox_head import RCNNTrainConfig as JRCNNCfg
from erd_tpu.models.heads.bbox_head import rcnn_loss as j_rcnn_loss
from erd_tpu.models.heads.bbox_head import \
    rcnn_sample_single as j_rcnn_sample_single
from erd_tpu.models.heads.gfl_head import AnchorContext as JAnchorContext
from erd_tpu.models.heads.rpn_head import rpn_anchor_generator as j_rpn_gen
from erd_tpu.models.heads.rpn_head import rpn_loss as j_rpn_loss
from erd_tpu.models.layers import cast_compute_params
from erd_tpu.ops.roi_align import multilevel_roi_align as j_multilevel
from erd_tpu.structures.det_sample import GTInstances as JGTInstances
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu.task.coder import DeltaXYWHBBoxCoder as JCoder
from erd_tpu.task.max_iou import max_iou_assign as j_max_iou_assign
from erd_tpu.task.samplers import random_sample as j_random_sample
from erd_tpu_torch.apis import build_detector, build_trainer
from erd_tpu_torch.config import Config
from erd_tpu_torch.engine import resnet_frozen_paths
from erd_tpu_torch.losses import l1_loss, smooth_l1_loss
from erd_tpu_torch.models import VFNetDetector
from erd_tpu_torch.models.heads import AnchorContext, rpn_anchor_generator
from erd_tpu_torch.models.heads.bbox_head import (RCNNTrainConfig,
                                                  rcnn_loss, rcnn_sample)
from erd_tpu_torch.models.heads.rpn_head import RPNTrainConfig, rpn_loss
from erd_tpu_torch.models.weight_import import params_from_jax
from erd_tpu_torch.ops import (CARAFEPack, carafe, deform_im2col,
                               map_roi_levels, ms_deform_attn,
                               multilevel_roi_align, roi_align)
from erd_tpu_torch.ops.roi_align import roi_align_backward_plain
from erd_tpu_torch.structures import GTInstances, ImageMeta, stack_to
from erd_tpu_torch.task import DeltaXYWHBBoxCoder, max_iou_assign
from erd_tpu_torch.task import random_sample
from tests.test_torch_carafe_crowddet import arranged_carafe
from tests.test_torch_train import OneBatchLoader, Recorder

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'frcnn': os.path.join(ROOT, 'configs', 'faster_rcnn',
                          'faster_rcnn_r50_fpn_1x_coco.py'),
    'carafe': os.path.join(ROOT, 'configs', 'carafe',
                           'faster_rcnn_r50_fpn_carafe_1x_coco.py'),
    'crowddet': os.path.join(ROOT, 'configs', 'crowddet',
                             'crowddet-rcnn_r50_fpn_8xb2-30e_crowdhuman.py')}
CANVAS = (96, 128)
IMG_SHAPES = [(96, 128), (80, 112)]
IMG_IDS = (3, 5)
MAX_GT = 4
GTS = [([[10, 10, 60, 50], [30, 5, 90, 40], [64, 40, 120, 92]], [1, 3, 0]),
       ([[5, 5, 40, 40], [44, 30, 100, 76]], [2, 1])]
# CrowdDet's: one class, and in each image two people overlapping at IoU
# 0.81, so that RoIs hold two gts at IoU >= 0.5 (EMD's second slot)
CROWD_GTS = [([[10, 10, 60, 50], [12, 8, 64, 52], [64, 40, 120, 92]],
              [0, 0, 0]),
             ([[5, 5, 40, 40], [44, 30, 100, 76], [40, 28, 96, 78]],
              [0, 0, 0])]


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, 1)))


def small_cfg(config_cls, kind):
    """The config at depth 18 in float32; 4 classes but for CrowdDet."""
    cfg = config_cls.fromfile(CONFIGS[kind])
    cfg.model.depth = 18
    cfg.model.compute_dtype = 'float32'
    if kind != 'crowddet':
        cfg.model.num_classes = 4
    return cfg


def numpy_batch(kind):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (2,) + CANVAS + (3,), dtype=np.uint8)
    gt = [JGTInstances.pad(np.asarray(b, np.float32), lab, MAX_GT)
          for b, lab in (CROWD_GTS if kind == 'crowddet' else GTS)]
    meta = [JImageMeta.make(s, s, (1.0, 1.0), img_id=i)
            for s, i in zip(IMG_SHAPES, IMG_IDS)]
    return images, gt, meta


def jax_batch(kind):
    images, gt, meta = numpy_batch(kind)
    stack = lambda items: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.asarray(np.stack(xs)), *items)
    return dict(images=jnp.asarray(images), gt=stack(gt), meta=stack(meta))


def port_records(cls, records):
    """erd_tpu's per-image records as one batched record of the port's
    ``cls`` (the fields it has)."""
    return stack_to([cls(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(cls)})
                     for r in records], 'cpu')


def port_batch(kind):
    images, gt, meta = numpy_batch(kind)
    return dict(images=torch.from_numpy(images),
                gt=port_records(GTInstances, gt),
                meta=port_records(ImageMeta, meta))


def rpn_rngs(id_sum, b):
    """The per-image keys erd_tpu's loss hands its RPN sampler."""
    return jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(0), id_sum), b)


def rcnn_rngs(id_sum, b):
    """The per-image keys erd_tpu's loss hands its R-CNN sampler."""
    return jax.random.split(jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(0), id_sum), 1), b)


def jax_draws(id_sum, b, n_anchors, n_candidates):
    """The four uniform key tensors of erd_tpu's samplers, as the port's
    ``loss(..., draws=...)`` takes them."""
    rpn = [jax.random.split(k) for k in rpn_rngs(id_sum, b)]
    rcnn = [jax.random.split(k) for k in rcnn_rngs(id_sum, b)]

    def uniform(keys, i, n):  # random_sample's split(rng) -> (kp, kn)
        return torch.from_numpy(np.stack(
            [np.array(jax.random.uniform(k[i], (n,))) for k in keys]))
    return (uniform(rpn, 0, n_anchors), uniform(rpn, 1, n_anchors),
            uniform(rcnn, 0, n_candidates), uniform(rcnn, 1, n_candidates))


def jax_train_run(kind):
    """erd_tpu's loss of one batch and its gradients in the parameters and
    in the FPN levels, the levels themselves, the training proposals, and
    the R-CNN samples drawn from them with the loss's own keys."""
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
    batch = jax_batch(kind)
    consts = {k: v for k, v in variables.items() if k != 'params'}
    module = j_crowddet_module if kind == 'crowddet' else j_frcnn_module
    first_stage = type(jdet)._feats_and_rpn.__get__(jdet)
    ctx = JAnchorContext.build(CANVAS, j_rpn_gen())
    n_levels = len(ctx.featmap_sizes)

    def total(params, probes):
        """The loss with a zero probe added to each FPN level, whose
        gradient is the levels' gradient."""
        captured = []
        proposals = module.rpn_proposals

        def capture(*args, **kw):
            captured.append(proposals(*args, **kw))
            return captured[-1]

        def feats_and_rpn(v, images):
            feats, _, _ = first_stage(v, images)
            feats = [f + q for f, q in zip(feats, probes)]
            captured.append(feats)
            rpn_cls, rpn_reg = jdet.net.apply(cast_compute_params(
                v, jdet.compute_dtype), feats, method='rpn')
            return feats, rpn_cls, rpn_reg
        module.rpn_proposals = capture
        jdet._feats_and_rpn = feats_and_rpn
        try:
            losses = jdet.loss({'params': params, **consts}, batch)
        finally:
            module.rpn_proposals = proposals
            del jdet._feats_and_rpn
        return sum(losses.values()), (losses, captured[0], captured[1])

    shapes = [(2, (CANVAS[0] + s - 1) // s, (CANVAS[1] + s - 1) // s, 256)
              for s in ctx.strides]
    probes = [jnp.zeros(s, jnp.float32) for s in shapes[:n_levels]]
    (_, (losses, feats, props)), (grads, feat_grads) = jax.jit(
        jax.value_and_grad(total, argnums=(0, 1), has_aux=True))(
        variables['params'], probes)
    boxes, _, mask = props
    gt = batch['gt']
    samples = jax.jit(jax.vmap(lambda k, pb, pm, gb, gl, gm:
                               j_rcnn_sample_single(
                                   k, pb, pm, gb, gl, gm, jdet.num_classes,
                                   jdet.rcnn_coder, jdet.rcnn_train_cfg)))(
        rcnn_rngs(sum(IMG_IDS), 2), boxes, mask, gt.bboxes, gt.labels,
        gt.mask)
    n_cand = int(boxes.shape[1]) + MAX_GT
    return dict(
        variables=variables,
        losses={k: float(v) for k, v in losses.items()},
        grads=params_from_jax(to_numpy({'params': grads})),
        feats=[np.asarray(f) for f in feats],
        feat_grads=[np.asarray(g) for g in feat_grads],
        samples=jax.tree.map(np.asarray, samples),
        proposals=(np.asarray(boxes), np.asarray(mask)),
        draws=jax_draws(sum(IMG_IDS), 2, ctx.num_anchors, n_cand))


def port_detector_and_net(kind, run):
    det = build_detector(small_cfg(Config, kind).model)
    net = det.build_net()
    net.load_state_dict(params_from_jax(run['variables']), strict=True)
    return det, net


def record_samples(monkeypatch):
    """Record every ``rcnn_sample`` result of the port's loss."""
    import erd_tpu_torch.models.detectors.faster_rcnn as frcnn_module
    seen = []
    sample = frcnn_module.rcnn_sample

    def wrapper(*args, **kw):
        seen.append(sample(*args, **kw))
        return seen[-1]
    monkeypatch.setattr(frcnn_module, 'rcnn_sample', wrapper)
    return seen


def use_jax_proposals(monkeypatch, run, score_rtol):
    """Hold the port's training proposals against erd_tpu's, then hand
    erd_tpu's on, so that both samplers see the same candidates. Masks must
    be equal and boxes within 1e-2 px, but for adjacent slots whose boxes
    are swapped where the port's scores are within ``score_rtol``: a
    near-tie whose order float noise decides. From identical features
    (``score_rtol`` 1e-6, the RPN convolution's rounding) it happens once,
    in the CrowdDet batch, slots 695 / 696 of image 0, scores 0.016945086
    and 0.016945070; through the whole network (1e-4, the network
    tolerance) once in the FPN-CARAFE batch, at scores 0.4314 7.7e-7
    apart. Kept, each would change one negative sample. Returns the list
    of swapped slots per call."""
    import erd_tpu_torch.models.detectors.faster_rcnn as frcnn_module
    proposals = frcnn_module.rpn_proposals
    swaps = []
    want_boxes, want_mask = (torch.from_numpy(a.copy())
                             for a in run['proposals'])

    def wrapper(*args, **kw):
        boxes, scores, mask = proposals(*args, **kw)
        assert torch.equal(mask, want_mask)
        off = ((boxes - want_boxes).abs().amax(-1) > 1e-2).nonzero().tolist()
        for i, k in off:
            j = int((boxes[i] - want_boxes[i, k]).abs().amax(-1).argmin())
            assert abs(j - k) == 1 and float(
                (boxes[i, j] - want_boxes[i, k]).abs().max()) <= 1e-2
            assert abs(float(scores[i, j] - scores[i, k])) <= \
                score_rtol * float(scores[i, k])
        swaps.append(off)
        return want_boxes, scores, want_mask
    monkeypatch.setattr(frcnn_module, 'rpn_proposals', wrapper)
    return swaps


def assert_same_samples(got, want):
    """The port's RoISamples against erd_tpu's: the same candidates in the
    same slots."""
    for name in ('labels', 'is_pos', 'valid', 'gt_idx'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_allclose(got.rois.numpy(), want.rois, rtol=0,
                               atol=1e-2)
    assert got.valid.sum() > 256 and got.is_pos.sum() >= 5


def assert_grads(named, want, rtol, atol_rel, names=None):
    """Each parameter's .grad against ``want`` (a state-dict-shaped map);
    frozen ones have none."""
    frozen = resnet_frozen_paths(1)
    checked = 0
    for name, p in named:
        if names is not None and not name.startswith(names):
            continue
        if name.startswith(frozen):
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=rtol,
                                   atol=atol_rel * np.abs(w).max(),
                                   err_msg=name)
        checked += 1
    return checked


def check_loss_from_feats(kind, run, monkeypatch):
    """The port's loss on erd_tpu's FPN levels: proposals, samples, losses,
    the levels' gradients and every head parameter's gradient."""
    det, net = port_detector_and_net(kind, run)
    swaps = use_jax_proposals(monkeypatch, run, 1e-6)
    seen = record_samples(monkeypatch)
    feats = [nchw(f).requires_grad_() for f in run['feats']]
    rpn_cls, rpn_reg = net.rpn_head(feats)
    b = port_batch(kind)
    losses = det.loss_from_feats(net, CANVAS, feats, rpn_cls, rpn_reg,
                                 b['gt'], b['meta'], run['draws'])
    assert len(swaps) == 1
    assert_same_samples(seen[0], run['samples'])
    assert set(losses) == set(run['losses'])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run['losses'][k], rtol=1e-5,
                                   err_msg=k)
    sum(losses.values()).backward()
    for f, w in zip(feats, run['feat_grads']):
        w = np.moveaxis(w, -1, 1)
        np.testing.assert_allclose(f.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
    n = assert_grads(net.named_parameters(), run['grads'], 1e-4, 1e-5,
                     ('rpn_head.', 'roi_head.'))
    assert n >= 10


def check_whole_network(kind, run, monkeypatch):
    det, net = port_detector_and_net(kind, run)
    swaps = use_jax_proposals(monkeypatch, run, 1e-4)
    seen = record_samples(monkeypatch)
    losses = det.loss(net, port_batch(kind), draws=run['draws'])
    assert len(swaps) == 1
    assert_same_samples(seen[0], run['samples'])
    assert set(losses) == set(run['losses'])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run['losses'][k], rtol=1e-4,
                                   err_msg=k)
    sum(losses.values()).backward()
    n = assert_grads(net.named_parameters(), run['grads'], 1e-3, 1e-5)
    assert n == sum(1 for p in net.parameters() if p.requires_grad)


def check_fit(kind):
    """build_trainer + fit of the config (depth 18) for two steps on the
    CPU: finite losses, the frozen stem and layer1 unchanged, every
    trainable weight moved."""
    cfg = small_cfg(Config, kind)
    cfg.train_cfg.epochs = 1
    cfg.optim.update(lr=0.16, warmup_factor=1.0)
    det = build_detector(cfg.model)
    net = det.init(seed=3, device='cpu')
    start = copy.deepcopy(net.state_dict())
    rec = Recorder()
    trainer = build_trainer(cfg, det, OneBatchLoader(port_batch(kind), 2),
                            device='cpu')
    trainer.hooks.append(rec)
    trainer.fit(net)
    assert rec.calls[-1] == 'after_epoch 0' and len(rec.losses) == 2
    for losses in rec.losses:
        assert all(np.isfinite(v) for v in losses.values()), losses
    frozen = resnet_frozen_paths(1)
    trainable = {n for n, p in net.named_parameters() if p.requires_grad}
    assert trainable and not any(n.startswith(frozen) for n in trainable)
    for name, value in net.state_dict().items():
        moved = not torch.equal(value, start[name])
        assert not (name.startswith(frozen) and moved), name
        if name in trainable and value.dim() > 1:
            assert moved, name
    return rec.losses


# ------------------------------------------------------------- assigner
@pytest.mark.parametrize('low_quality', [True, False])
def test_max_iou_assign_matches_jax(low_quality):
    """Random boxes on a 1/8 grid with planted exact ties (anchors equal to
    a gt, one anchor at the best IoU of two gts), padded gts and invalid
    anchors, batched over 2 images."""
    rs = np.random.RandomState(1)
    n, g = 300, 6
    xy = np.round(rs.uniform(0, 200, (n, 2)) * 8) / 8
    anchors = np.concatenate([xy, xy + np.round(rs.uniform(8, 80, (n, 2)) *
                                                8) / 8], -1)
    gts = np.zeros((2, g, 4))
    for i in range(2):
        gxy = np.round(rs.uniform(0, 200, (g, 2)) * 8) / 8
        gts[i] = np.concatenate([gxy, gxy + rs.uniform(16, 90, (g, 2))], -1)
    gts[:, 1] = anchors[7]          # an anchor equal to a gt
    gts[:, 2] = anchors[7]          # twice: the higher gt index must win
    anchors[11] = anchors[12]       # two anchors tying a gt's best IoU
    gts[:, 3] = anchors[11] + 1.0
    anchors = anchors.astype(np.float32)
    gts = gts.astype(np.float32)
    labels = rs.randint(0, 5, (2, g))
    mask = np.ones((2, g), bool)
    mask[1, 4:] = False             # padded gts
    valid = rs.rand(2, n) > 0.1     # invalid anchors
    valid[:, [7, 11, 12]] = True
    kw = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
              match_low_quality=low_quality)
    # op by op: under jit, XLA fuses the IoU into the row max and moves
    # max_overlaps by an ulp at a few anchors
    want = jax.vmap(lambda b, lab, m, v: j_max_iou_assign(
        jnp.asarray(anchors), b, lab, m, valid_flags=v, **kw))(
        jnp.asarray(gts), jnp.asarray(labels), jnp.asarray(mask),
        jnp.asarray(valid))
    got = max_iou_assign(torch.from_numpy(anchors), torch.from_numpy(gts),
                         torch.from_numpy(labels), torch.from_numpy(mask),
                         valid_flags=torch.from_numpy(valid), **kw)
    for name in ('pos_mask', 'gt_idx', 'max_overlaps', 'labels'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    if low_quality:
        assert int(got.gt_idx[0, 7]) == 2 and bool(got.pos_mask[0, 11]) and \
            bool(got.pos_mask[0, 12])
    assert (got.labels == -2).any() and (got.labels == -1).any()


# -------------------------------------------------------------- sampler
@pytest.mark.parametrize('n_pos,n_neg', [(3, 40), (200, 900)])
def test_random_sample_matches_jax_draws(n_pos, n_neg):
    """Few eligible entries leave -inf tie slots, filled lowest index
    first; many fill every slot."""
    rs = np.random.RandomState(n_pos)
    n = 1200
    pos = np.zeros(n, bool)
    neg = np.zeros(n, bool)
    perm = rs.permutation(n)
    pos[perm[:n_pos]] = True
    neg[perm[n_pos:n_pos + n_neg]] = True
    key = jax.random.PRNGKey(n_pos)
    want = jax.jit(lambda k: j_random_sample(k, jnp.asarray(pos),
                                             jnp.asarray(neg)))(key)
    kp, kn = jax.random.split(key)
    got = random_sample(torch.from_numpy(pos), torch.from_numpy(neg),
                        torch.from_numpy(np.array(
                            jax.random.uniform(kp, (n,)))),
                        torch.from_numpy(np.array(
                            jax.random.uniform(kn, (n,)))))
    for name in ('idx', 'is_pos', 'valid'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert bool(got.valid.all()) == (n_pos >= 128 and n_neg >= 384)


# ------------------------------------------------------------- losses
def test_l1_and_smooth_l1_match_jax():
    rs = np.random.RandomState(2)
    pred, target = rs.randn(2, 50, 4).astype(np.float32) * 2, \
        rs.randn(2, 50, 4).astype(np.float32)
    weight = rs.rand(2, 50, 4).astype(np.float32)
    for red in ('none', 'sum', 'mean'):
        np.testing.assert_allclose(
            l1_loss(torch.from_numpy(pred), torch.from_numpy(target),
                    torch.from_numpy(weight), reduction=red).numpy(),
            np.asarray(j_l1_loss(pred, target, weight, reduction=red)),
            rtol=1e-6)
        np.testing.assert_allclose(
            smooth_l1_loss(torch.from_numpy(pred), torch.from_numpy(target),
                           torch.from_numpy(weight), beta=0.5,
                           reduction=red).numpy(),
            np.asarray(j_smooth_l1_loss(pred, target, weight, beta=0.5,
                                        reduction=red)), rtol=1e-6)


def rpn_case(rs):
    ctx = AnchorContext.build(CANVAS, rpn_anchor_generator())
    n = ctx.num_anchors
    cls = (rs.randn(2, n) * 2).astype(np.float32)
    reg = (rs.randn(2, n, 4) * 0.5).astype(np.float32)
    _, gt, meta = numpy_batch('frcnn')
    return ctx, cls, reg, gt, meta


def test_rpn_loss_matches_jax():
    """The RPN loss from identical head outputs and erd_tpu's keys: the
    sample sets exactly (assignment on the padded image's valid anchors),
    the losses rtol 1e-6, their gradients in the head outputs."""
    rs = np.random.RandomState(4)
    ctx, cls, reg, gt, meta = rpn_case(rs)
    jgt = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *gt)
    jshape = jnp.asarray(np.stack([m.img_shape for m in meta]))
    jctx = JAnchorContext.build(CANVAS, j_rpn_gen())

    def jloss(c, r):
        out = j_rpn_loss(jctx, c, r, jgt, jshape,
                         jax.random.fold_in(jax.random.PRNGKey(0), 8),
                         JCoder())
        return sum(out.values()), out
    (_, want), (gc, gr) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(cls),
                                               jnp.asarray(reg))
    draws = jax_draws(8, 2, ctx.num_anchors, 1)
    tgt = port_records(GTInstances, gt)
    tmeta = port_records(ImageMeta, meta)
    c, r = torch.from_numpy(cls).requires_grad_(), \
        torch.from_numpy(reg).requires_grad_()
    got = rpn_loss(ctx, c, r, tgt, tmeta.img_shape, draws[0], draws[1],
                   DeltaXYWHBBoxCoder(), RPNTrainConfig())
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    sum(got.values()).backward()
    for t, w in ((c, gc), (r, gr)):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
    # the sample sets, by erd_tpu's assignment and sampler per image
    anchors = jnp.asarray(jctx.anchors)
    from erd_tpu.task.anchors import valid_flags_jax
    from erd_tpu_torch.task import valid_flags
    pad = torch.ceil(tmeta.img_shape / 32) * 32
    vf = valid_flags(ctx.featmap_sizes, ctx.strides,
                     pad).repeat_interleave(3, dim=-1)
    res = max_iou_assign(torch.from_numpy(jctx.anchors), tgt.bboxes,
                         torch.zeros_like(tgt.labels), tgt.mask,
                         pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                         valid_flags=vf)
    mine = random_sample(res.pos_mask & vf,
                         ~res.pos_mask & (res.labels != -2) & vf,
                         draws[0], draws[1], num=256, pos_fraction=0.5)
    for i in range(2):
        jvf = valid_flags_jax(jctx.featmap_sizes, jctx.strides,
                              jnp.ceil(jshape[i] / 32) * 32,
                              num_base_anchors=3)
        np.testing.assert_array_equal(vf[i].numpy(), np.asarray(jvf))
        jres = j_max_iou_assign(anchors, jgt.bboxes[i],
                                jnp.zeros_like(jgt.labels[i]), jgt.mask[i],
                                pos_iou_thr=0.7, neg_iou_thr=0.3,
                                min_pos_iou=0.3, valid_flags=jvf)
        js = j_random_sample(
            rpn_rngs(8, 2)[i], jres.pos_mask & jvf,
            (~jres.pos_mask) & (jres.labels != -2) & jvf, num=256,
            pos_fraction=0.5)
        for name in ('idx', 'is_pos', 'valid'):
            np.testing.assert_array_equal(getattr(mine, name)[i].numpy(),
                                          np.asarray(getattr(js, name)),
                                          err_msg=name)
        assert int(mine.is_pos[i][mine.valid[i]].sum()) >= 2


def test_rcnn_sample_and_loss_match_jax():
    """The R-CNN sampler on identical proposals (gt boxes joined ahead of
    them) with erd_tpu's keys, exactly; the loss on identical head
    outputs, rtol 1e-6, and its gradients."""
    rs = np.random.RandomState(5)
    _, gt, meta = numpy_batch('frcnn')
    jgt = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *gt)
    r, nc = 300, 4
    xy = rs.uniform(0, 110, (2, r, 2))
    props = np.concatenate([xy, xy + rs.uniform(8, 70, (2, r, 2))],
                           -1).astype(np.float32)
    for i, (b, _) in enumerate(GTS):  # a few proposals near the gts
        props[i, :12] = np.asarray(b, np.float32)[rs.randint(len(b), size=12)]
        props[i, :12] += rs.normal(0, 4, (12, 4)).astype(np.float32)
    pmask = rs.rand(2, r) > 0.1
    cfg, jcfg = RCNNTrainConfig(num_samples=128), JRCNNCfg(num_samples=128)
    keys = rcnn_rngs(8, 2)
    coder_std = (0.1, 0.1, 0.2, 0.2)
    want = jax.jit(jax.vmap(lambda k, p, m, gb, gl, gm: j_rcnn_sample_single(
        k, p, m, gb, gl, gm, nc, JCoder(target_stds=coder_std), jcfg)))(
        keys, jnp.asarray(props), jnp.asarray(pmask), jgt.bboxes,
        jgt.labels, jgt.mask)
    draws = jax_draws(8, 2, 1, r + MAX_GT)
    tgt = port_records(GTInstances, gt)
    got = rcnn_sample(torch.from_numpy(props), torch.from_numpy(pmask), tgt,
                      nc, DeltaXYWHBBoxCoder(target_stds=coder_std),
                      draws[2], draws[3], cfg)
    for name in ('labels', 'is_pos', 'valid', 'gt_idx'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas),
                               rtol=1e-6, atol=1e-6)
    assert int(got.is_pos.sum()) >= 10 and not bool(got.valid.all())
    cls = (rs.randn(2 * 128, nc + 1) * 2).astype(np.float32)
    reg = rs.randn(2 * 128, 4 * nc).astype(np.float32)

    def jloss(c, rg):
        out, _ = j_rcnn_loss(c, rg, want, nc, jcfg)
        return sum(out.values()), out
    (_, jl), (gc, gr) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(cls),
                                               jnp.asarray(reg))
    c = torch.from_numpy(cls).requires_grad_()
    rg = torch.from_numpy(reg).requires_grad_()
    tl = rcnn_loss(c.view(2, 128, -1), rg.view(2, 128, -1), got, cfg)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-6,
                                   err_msg=k)
    sum(tl.values()).backward()
    for t, w in ((c, gc), (rg, gr)):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


# -------------------------------------------------- RoIAlign backward
def roi_case(rs):
    """P2-P5 maps of a 128x160 canvas and RoIs on every level, with edge
    cases: outside the image, over the last row or column, tiny, zero."""
    sizes = [(32, 40), (16, 20), (8, 10), (4, 5)]
    feats = [(rs.randn(2, h, w, 8)).astype(np.float32) for h, w in sizes]
    r = 40
    xy = rs.uniform(-20, 150, (2, r, 2))
    wh = np.exp(rs.uniform(np.log(4), np.log(700), (2, r, 1))) * \
        rs.uniform(0.6, 1.4, (2, r, 2))
    rois = np.concatenate([xy, xy + wh], -1)
    rois[:, :8] = [[-60, -40, -2, -1], [165, 0, 250, 40], [10, 10, 10, 10],
                   [0, 0, 0, 0], [152, 120, 164, 132], [156, 0, 160, 128],
                   [-300, -300, 400, 400], [-200, -100, 500, 420]]
    return feats, rois.astype(np.float32)


def test_roi_align_backward_plain_matches_jax_vjp():
    rs = np.random.RandomState(6)
    feats, rois = roi_case(rs)
    levels = map_roi_levels(torch.from_numpy(rois), 4)
    assert set(levels.flatten().tolist()) == {0, 1, 2, 3}
    grad = rs.randn(2, rois.shape[1], 7, 7, 8).astype(np.float32)

    def jfn(*fs):
        return jax.vmap(lambda a, b, c, d, r: j_multilevel(
            [a, b, c, d], r))(*fs, jnp.asarray(rois))
    _, vjp = jax.vjp(jfn, *[jnp.asarray(f) for f in feats])
    want = jax.jit(vjp)(jnp.asarray(grad))
    got = roi_align_backward_plain(
        torch.from_numpy(np.ascontiguousarray(grad.transpose(0, 1, 4, 2,
                                                             3))),
        torch.from_numpy(rois), levels.int(),
        [f.shape[1:3] for f in feats], (4, 8, 16, 32))
    for g, w in zip(got, want):
        w = np.moveaxis(np.asarray(w), -1, 1)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
        assert np.abs(w).max() > 0


def test_roi_align_backward_plain_matches_jax_vjp_at_out_14():
    """The mask branch's call: out_size 14 on every level, a third of the
    RoIs with a zero output gradient (the negatives that the mask loss
    does not count)."""
    rs = np.random.RandomState(16)
    feats, rois = roi_case(rs)
    levels = map_roi_levels(torch.from_numpy(rois), 4)
    grad = rs.randn(2, rois.shape[1], 14, 14, 8).astype(np.float32)
    grad[:, 1::3] = 0.0

    def jfn(*fs):
        return jax.vmap(lambda a, b, c, d, r: j_multilevel(
            [a, b, c, d], r, out_size=14))(*fs, jnp.asarray(rois))
    _, vjp = jax.vjp(jfn, *[jnp.asarray(f) for f in feats])
    want = jax.jit(vjp)(jnp.asarray(grad))
    got = roi_align_backward_plain(
        torch.from_numpy(np.ascontiguousarray(grad.transpose(0, 1, 4, 2,
                                                             3))),
        torch.from_numpy(rois), levels.int(),
        [f.shape[1:3] for f in feats], (4, 8, 16, 32), out_size=14)
    for g, w in zip(got, want):
        w = np.moveaxis(np.asarray(w), -1, 1)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
        assert np.abs(w).max() > 0


def test_roi_align_backward_scratch_layout():
    """The backward kernel's scratch, from the call's shape: channels-last
    float32 levels with C rounded up to 4, then a flag byte a 32-pixel
    tile of each level, in whole floats."""
    from erd_tpu_torch.ops.roi_align import _backward_scratch, \
        scratch_channels
    assert [scratch_channels(c) for c in (1, 4, 18, 20, 256)] == \
        [4, 4, 20, 20, 256]
    shapes = [(200, 336), (100, 168), (50, 84), (25, 42)]
    grad = torch.empty((16, 512, 256, 7, 7), device='meta')
    pixels = sum(h * w for h, w in shapes)
    flags = 16 * sum(-(-h * w // 32) for h, w in shapes)
    scratch = _backward_scratch(grad, shapes)
    assert scratch.dtype == torch.float32 and scratch.dim() == 1
    assert scratch.numel() == 16 * pixels * 256 + -(-flags // 4)
    grad = torch.empty((2, 3, 18, 14, 14), device='meta')
    assert _backward_scratch(grad, [(5, 7)]).numel() == \
        2 * 35 * 20 + 1  # two tiles of 32 pixels: 2 bytes, one float


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_roi_align_autograd_runs_its_backward(dtype):
    """``multilevel_roi_align`` carries the maps' gradient through
    ``roi_align_backward`` (rounded once to the maps' dtype); the RoIs
    take none."""
    rs = np.random.RandomState(7)
    feats, rois = roi_case(rs)
    fs = [nchw(f).to(dtype).requires_grad_() for f in feats]
    tr = torch.from_numpy(rois).requires_grad_()
    out = multilevel_roi_align(fs, tr)
    assert out.grad_fn is not None and out.dtype == torch.float32
    g = torch.from_numpy(rs.randn(*out.shape).astype(np.float32))
    out.backward(g)
    want = roi_align_backward_plain(g, tr.detach(), map_roi_levels(
        tr.detach(), 4), [f.shape[2:] for f in fs], (4, 8, 16, 32))
    for f, w in zip(fs, want):
        assert f.grad.dtype == dtype
        assert torch.equal(f.grad, w.to(dtype))
    assert tr.grad is None


def test_roi_align_function_passes_gradcheck():
    """Finite differences of ``roi_align`` in float64 on the plain path:
    two levels, RoIs inside, across the edges and on each level."""
    rs = np.random.RandomState(9)
    fs = [torch.from_numpy(rs.randn(1, 2, h, w)).requires_grad_()
          for h, w in ((5, 6), (3, 3))]
    rois = torch.tensor([[[1.0, 2.0, 13.0, 15.0], [-3.0, 10.0, 25.0, 22.0],
                          [2.0, 1.0, 30.0, 20.0]]])
    levels = torch.tensor([[0, 0, 1]], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda *f: roi_align(list(f), rois, levels, (4, 8)), tuple(fs))


# ------------------------------------------------- the whole slice
@pytest.fixture(scope='module')
def frcnn_run():
    return jax_train_run('frcnn')


def test_loss_from_feats_matches_jax(frcnn_run, monkeypatch):
    check_loss_from_feats('frcnn', frcnn_run, monkeypatch)


def test_whole_network_loss_and_grads_match_jax(frcnn_run, monkeypatch):
    check_whole_network('frcnn', frcnn_run, monkeypatch)


def test_loss_draws_from_a_seeded_generator():
    """Without ``draws`` the keys come from a generator seeded with the
    batch's img_id sum: ``train_draws`` of those ids, which differ for
    other ids."""
    det = build_detector(small_cfg(Config, 'frcnn').model)
    net = det.init(seed=1, device='cpu')
    batch = port_batch('frcnn')
    ids = batch['meta'].img_id
    n = det.anchor_context(CANVAS).num_anchors
    draws = det.train_draws(ids, 2, n, 1000 + MAX_GT, 'cpu')
    with torch.no_grad():
        a = det.loss(net, batch)
        b = det.loss(net, batch, draws=draws)
    assert all(torch.equal(a[k], b[k]) for k in a)
    other = det.train_draws(ids + 1, 2, n, 1000 + MAX_GT, 'cpu')
    assert all(d.shape == o.shape and not torch.equal(d, o)
               for d, o in zip(draws, other))


def test_fit_two_steps_from_the_faster_rcnn_config():
    losses = check_fit('frcnn')
    assert set(losses[0]) == {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                              'loss_bbox'}


# ------------------------ wrappers, build_detector and build_trainer rules
@pytest.mark.parametrize('op', ['roi_align', 'carafe', 'ms_deform_attn',
                                'deform_im2col'])
def test_kernel_wrappers_keep_or_refuse_gradients(op):
    """On the CPU path: roi_align, carafe, ms_deform_attn and
    deform_im2col return outputs with a grad_fn when an input needs a
    gradient (the name is from before the backwards of ms_deform_attn and
    deform_im2col were ported, when they raised)."""
    rs = np.random.RandomState(8)
    if op == 'roi_align':
        feats, rois = roi_case(rs)
        fs = [nchw(f).requires_grad_() for f in feats]
        out = roi_align(fs, torch.from_numpy(rois),
                        map_roi_levels(torch.from_numpy(rois), 4))
        assert out.grad_fn is not None
    elif op == 'carafe':
        x = torch.randn(1, 4, 3, 5, requires_grad=True)
        out = carafe(x, torch.randn(1, 100, 3, 5))
        assert out.grad_fn is not None
        out.sum().backward()
        assert x.grad is not None and x.grad.abs().max() > 0
        pack = CARAFEPack(4)
        assert pack(x).grad_fn is not None
    elif op == 'ms_deform_attn':
        values = torch.randn(1, 6, 2, 4)
        args = ([(2, 3)], torch.rand(1, 3, 2, 1, 2, 2),
                torch.rand(1, 3, 2, 1, 2))
        with torch.no_grad():
            assert ms_deform_attn(values.requires_grad_(),
                                  *args).grad_fn is None
        out = ms_deform_attn(values, *args)
        assert out.grad_fn is not None
        out.sum().backward()
        assert values.grad is not None and values.grad.abs().max() > 0
    else:
        x = torch.randn(1, 4, 5, 6, requires_grad=True)
        offset = (torch.randn(1, 18, 5, 6) * 1.5).requires_grad_()
        with torch.no_grad():
            assert deform_im2col(x, offset, None).grad_fn is None
        out = deform_im2col(x, offset, torch.rand(1, 9, 5, 6))
        assert out.grad_fn is not None
        out.sum().backward()
        assert x.grad.abs().max() > 0 and offset.grad.abs().max() > 0


def test_build_detector_and_trainer_train_rules():
    """The two-stage configs build with erd_tpu's train configs; the OHEM
    sampler and a teacher outside ERD raise; VFNet, DINO and Deformable
    DETR build trainers."""
    for kind in CONFIGS:
        det = build_detector(Config.fromfile(CONFIGS[kind]).model)
        assert det.rpn_train_cfg == RPNTrainConfig()
        assert det.rcnn_train_cfg == RCNNTrainConfig()
        assert (det.proposal_cfg_train.nms_pre,
                det.proposal_cfg_train.max_per_img) == (2000, 1000)
        assert det.frozen_stages == 1
    cfg = small_cfg(Config, 'frcnn')
    cfg.model.train_cfg = dict(rcnn_sampler='ohem')
    with pytest.raises(NotImplementedError, match='rcnn_sampler'):
        build_detector(cfg.model)
    # as in erd_tpu, the sampler is a two-stage key: a one-stage model
    # ignores it
    assert type(build_detector(Config(
        type='GFL', train_cfg=dict(rcnn_sampler='ohem')))).__name__ == \
        'GFLDetector'
    loader = OneBatchLoader(port_batch('frcnn'), 1)
    det = build_detector(small_cfg(Config, 'frcnn').model)
    with pytest.raises(ValueError, match='without one'):
        build_trainer(small_cfg(Config, 'frcnn'), det, loader,
                      teacher=det.init(seed=0, device='cpu'), device='cpu')
    # VFNet trains since DCN training was ported, freezing the stem and
    # layer1 as erd_tpu's trainer does
    trainer = build_trainer(small_cfg(Config, 'frcnn'), build_detector(
        Config(type='VFNet', depth=18)), loader, device='cpu')
    assert isinstance(trainer.det, VFNetDetector)
    assert trainer.det.frozen_stages == 1
    for mtype in ('DINO', 'DeformableDETR'):
        trainer = build_trainer(small_cfg(Config, 'frcnn'),
                                build_detector(Config(type=mtype)), loader,
                                device='cpu')
        assert trainer.det.frozen_stages == 1
