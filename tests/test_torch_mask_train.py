"""Port parity of Mask R-CNN and PointRend training on the CPU: the mask
targets, the mask loss, the point-sample backward, PointRend's importance
sampling, the loss and every parameter gradient of both networks against
erd_tpu's ``value_and_grad``, and ``build_trainer`` + ``fit``.

The networks are the configs at depth 18 in float32 (4 classes), B = 2
images in a 96x128 canvas with 56x56 gt mask crops, erd_tpu's weights
carried over by ``params_from_jax`` (BN statistics and biases perturbed,
the RPN objectness and class kernels widened so that scores spread), 64
sampled RoIs an image on both sides (erd_tpu's 512 would spend minutes on
the CPU in the 256-wide mask heads; the slice's shapes run at 512 on the
card). The samplers' and PointRend's uniform keys are erd_tpu's own (the
``fold_in`` / ``split`` chain of its ``loss``), drawn with jax.random and
handed to the port's ``draws``. Tolerances, each with its reason:
- ``crop_resize_mask``: exactly (the port repeats XLA's float32 ops,
  its folded reciprocal and its fused multiply-adds);
- ``mask_loss``: rtol 1e-6, gradients rtol 1e-5 (sums reassociate);
- the point-sample backward against jax.vjp: atol 1e-6 * max|g| (the
  scatter's sums in another order);
- the whole network: the training proposals as
  tests/test_torch_frcnn_train.py holds them (erd_tpu's then go on to both
  samplers); PointRend's 147 importance points of each RoI equal
  erd_tpu's, but for picks at near-ties of the uncertainty (within 1e-5
  of the largest, which float noise in the coarse logits may order either
  way: 8 of the 18816 picks here; at most 1e-3 of them; erd_tpu's picks
  then go on); the loss dict rtol 1e-5;
  ||diff|| / ||g|| <= 1e-4 over all gradients and 1e-3 for each tensor.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erd_tpu.models.heads.rpn_head as j_rpn_head_module
from erd_tpu.apis.build import build_detector as j_build_detector
from erd_tpu.config import Config as JConfig
from erd_tpu.data.masks import crop_resize_mask as j_crop_resize_mask
from erd_tpu.models.heads.bbox_head import \
    rcnn_sample_single as j_rcnn_sample_single
from erd_tpu.models.heads.gfl_head import AnchorContext as JAnchorContext
from erd_tpu.models.heads.mask_head import mask_loss as j_mask_loss
from erd_tpu.models.heads.rpn_head import rpn_anchor_generator as j_rpn_gen
from erd_tpu.ops.sampling import point_sample as j_point_sample
from erd_tpu.structures.det_sample import GTInstances as JGTInstances
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector, build_trainer
from erd_tpu_torch.config import Config
from erd_tpu_torch.data.masks import (crop_resize_mask,
                                      crop_resize_mask_plain, pad_gt_masks)
from erd_tpu_torch.engine import resnet_frozen_paths
from erd_tpu_torch.models.heads.mask_head import mask_loss
from erd_tpu_torch.models.weight_import import params_from_jax
from erd_tpu_torch.ops import point_sample
from erd_tpu_torch.ops.sampling import (point_sample_backward,
                                        point_sample_backward_plain)
from erd_tpu_torch.structures import GTInstances, ImageMeta
from tests.test_torch_frcnn_train import (CANVAS, GTS, IMG_IDS, IMG_SHAPES,
                                          MAX_GT, jax_draws, port_records,
                                          rcnn_rngs, record_samples,
                                          to_numpy, use_jax_proposals)
from tests.test_torch_train import OneBatchLoader, Recorder

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'mask_rcnn': os.path.join(ROOT, 'configs', 'mask_rcnn',
                              'mask_rcnn_r50_fpn_1x_coco.py'),
    'point_rend': os.path.join(ROOT, 'configs', 'point_rend',
                               'point-rend_r50-caffe_fpn_ms-1x_coco.py')}
NUM_SAMPLES = 64
MASK_RES = 56


def small_cfg(config_cls, kind):
    cfg = config_cls.fromfile(CONFIGS[kind])
    cfg.model.depth = 18
    cfg.model.compute_dtype = 'float32'
    cfg.model.num_classes = 4
    return cfg


def with_samples(det):
    """``det`` sampling NUM_SAMPLES RoIs an image (either package)."""
    det.rcnn_train_cfg = dataclasses.replace(det.rcnn_train_cfg,
                                             num_samples=NUM_SAMPLES)
    return det


def gt_crops(rs, n):
    """n box-normalised 56x56 uint8 crops: a random ellipse each, with
    noise flipped in, as rasterised polygons look."""
    yy, xx = np.mgrid[:MASK_RES, :MASK_RES] + 0.5
    out = []
    for _ in range(n):
        cy, cx = rs.uniform(18, 38, 2)
        ry, rx = rs.uniform(10, 28, 2)
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        out.append((m ^ (rs.rand(MASK_RES, MASK_RES) < 0.03)).astype(
            np.uint8))
    return out


def numpy_batch():
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (2,) + CANVAS + (3,), dtype=np.uint8)
    crops = np.random.RandomState(4)
    gt = [JGTInstances.pad(np.asarray(b, np.float32), lab, MAX_GT,
                           masks=gt_crops(crops, len(b))) for b, lab in GTS]
    meta = [JImageMeta.make(s, s, (1.0, 1.0), img_id=i)
            for s, i in zip(IMG_SHAPES, IMG_IDS)]
    return images, gt, meta


def jax_batch():
    images, gt, meta = numpy_batch()
    stack = lambda items: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.asarray(np.stack(xs)), *items)
    return dict(images=jnp.asarray(images), gt=stack(gt), meta=stack(meta))


def port_batch():
    images, gt, meta = numpy_batch()
    return dict(images=torch.from_numpy(images),
                gt=port_records(GTInstances, gt),
                meta=port_records(ImageMeta, meta))


def point_draws(id_sum, r, k=196, frac=0.75, over=3):
    """erd_tpu's PointRend draws: rnd (R, k * over, 2) and rnd2 (R, k -
    n_imp, 2) from fold_in(fold_in(PRNGKey(0), id_sum), 99)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                id_sum), 99)
    n_imp = int(k * frac)
    return (torch.from_numpy(np.array(jax.random.uniform(
                key, (r, k * over, 2)))),
            torch.from_numpy(np.array(jax.random.uniform(
                jax.random.fold_in(key, 1), (r, k - n_imp, 2)))))


def jax_train_run(kind):
    """erd_tpu's loss of one batch, its gradients, the training proposals,
    the R-CNN samples drawn from them with the loss's own keys and
    (PointRend) the importance picks of its top-k."""
    jdet = with_samples(j_build_detector(small_cfg(JConfig, kind).model))
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
    p = variables['params']
    for scope, mod in (('rpn_head', 'rpn_cls'), ('bbox_head', 'fc_cls')):
        k = p[scope][mod]['kernel']
        k[...] = rs.normal(0, 0.3, k.shape)
    batch = jax_batch()
    consts = {k: v for k, v in variables.items() if k != 'params'}
    n_imp = int(196 * 0.75)

    def total(params):
        captured, picks = [], []
        proposals, top_k = j_rpn_head_module.rpn_proposals, jax.lax.top_k

        def capture(*args, **kw):
            captured.append(proposals(*args, **kw))
            return captured[-1]

        def top_k_capture(x, k):
            out = top_k(x, k)
            if k == n_imp:
                picks.append(out[1])
            return out
        j_rpn_head_module.rpn_proposals = capture
        jax.lax.top_k = top_k_capture
        try:
            losses = jdet.loss({'params': params, **consts}, batch)
        finally:
            j_rpn_head_module.rpn_proposals = proposals
            jax.lax.top_k = top_k
        return sum(losses.values()), (losses, captured[0],
                                      picks[0] if picks else None)

    (_, (losses, props, picks)), grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(variables['params'])
    boxes, _, mask = props
    gt = batch['gt']
    samples = jax.jit(jax.vmap(lambda k, pb, pm, gb, gl, gm:
                               j_rcnn_sample_single(
                                   k, pb, pm, gb, gl, gm, jdet.num_classes,
                                   jdet.rcnn_coder, jdet.rcnn_train_cfg)))(
        rcnn_rngs(sum(IMG_IDS), 2), boxes, mask, gt.bboxes, gt.labels,
        gt.mask)
    n_anchors = JAnchorContext.build(CANVAS, j_rpn_gen()).num_anchors
    draws = jax_draws(sum(IMG_IDS), 2, n_anchors,
                      int(boxes.shape[1]) + MAX_GT)
    if kind == 'point_rend':
        draws = draws + point_draws(sum(IMG_IDS), 2 * NUM_SAMPLES)
    return dict(
        variables=variables,
        losses={k: float(v) for k, v in losses.items()},
        grads=params_from_jax(to_numpy({'params': grads})),
        samples=jax.tree.map(np.asarray, samples),
        proposals=(np.asarray(boxes), np.asarray(mask)),
        picks=None if picks is None else np.asarray(picks),
        draws=draws)


def use_jax_picks(monkeypatch, want, rel=1e-5):
    """Hold the port's importance picks (the top 147 of -|uncertainty|)
    against erd_tpu's ``want`` (R, 147): the same points in the same
    order, but where the uncertainties of the two picks are within ``rel``
    of the largest: a near-tie that float noise in the coarse logits
    decides either way. erd_tpu's picks then go on. Returns the count of
    such near-tie picks."""
    import erd_tpu_torch.models.detectors.point_rend as pr_module
    topk = pr_module.topk_stable
    moved = []
    want = torch.from_numpy(want.astype(np.int64))

    def wrapper(values, k):
        top, idx = topk(values, k)
        if k != want.shape[1]:
            return top, idx
        off = idx != want
        theirs = torch.gather(values, 1, want)
        scale = values.abs().amax(-1, keepdim=True)
        assert bool(((top - theirs).abs() <= rel * scale)[off].all())
        moved.append(int(off.sum()))
        return theirs, want
    monkeypatch.setattr(pr_module, 'topk_stable', wrapper)
    return moved


def assert_same_samples(got, want):
    """The port's RoISamples against erd_tpu's: the same candidates in the
    same slots, every slot filled, positives in both images."""
    for name in ('labels', 'is_pos', 'valid', 'gt_idx'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_allclose(got.rois.numpy(), want.rois, rtol=0,
                               atol=1e-2)
    assert bool(got.valid.all()) and bool((got.is_pos.sum(1) >= 3).all())


def assert_grad_norms(net, want, overall=1e-4, per_tensor=1e-3):
    """||diff|| / ||g|| of the trainable parameters' .grad against
    ``want`` over all of them and for each; the frozen stem and layer1 have
    none."""
    frozen = resnet_frozen_paths(1)
    diffs, refs = [], []
    for name, p in net.named_parameters():
        if name.startswith(frozen):
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name]
        d = (p.grad - w).flatten().double()
        ref = w.flatten().double()
        assert d.norm() <= per_tensor * ref.norm() + 1e-12, \
            (name, float(d.norm() / ref.norm()))
        diffs.append(d)
        refs.append(ref)
    ratio = float(torch.cat(diffs).norm() / torch.cat(refs).norm())
    assert ratio <= overall, ratio
    return len(diffs)


@pytest.fixture(scope='module', params=['mask_rcnn', 'point_rend'])
def train_run(request):
    return request.param, jax_train_run(request.param)


# ---------------------------------------------------------- mask targets
def crop_case(rs, b=2, g=5, s=40):
    boxes = np.zeros((b, g, 4), np.float32)
    xy = rs.uniform(0, 90, (b, g, 2))
    boxes[..., :2] = xy
    boxes[..., 2:] = xy + rs.uniform(2, 60, (b, g, 2))
    boxes[0, 0] = [30, 30, 30, 30]          # degenerate: a point
    boxes[1, 1] = [10, 40, 80, 40.0005]     # degenerate: a line
    masks = np.stack([np.stack(gt_crops(rs, g)) for _ in range(b)])
    gidx = rs.randint(0, g, (b, s))
    xy = rs.uniform(-30, 110, (b, s, 2))
    rois = np.concatenate([xy, xy + rs.uniform(0, 90, (b, s, 2))], -1)
    rois[0, :6] = [[-50, -40, -10, -5], [120, 100, 180, 160],
                   [25, 25, 35, 35], [0, 0, 0, 0], [-20, -20, 200, 200],
                   [31, 29, 31.5, 29.2]]   # outside, beyond, tiny
    gidx[0, :6] = 0
    return masks, boxes, gidx, rois.astype(np.float32)


@pytest.mark.parametrize('out_size', [28, 14])
def test_crop_resize_mask_matches_jax_exactly(out_size):
    """Every (RoI, gt) pair of a batch, with RoIs outside, beyond and
    inside their gt box and degenerate gt boxes, equal to erd_tpu's jitted
    ``crop_resize_mask`` to the bit."""
    masks, boxes, gidx, rois = crop_case(np.random.RandomState(3))
    want = np.asarray(jax.jit(jax.vmap(lambda gm, gb, gi, rr: jax.vmap(
        lambda i, r: j_crop_resize_mask(gm[i], gb[i], r, out_size))(
        gi, rr)))(masks, boxes, gidx, rois))
    got = crop_resize_mask(torch.from_numpy(masks), torch.from_numpy(boxes),
                           torch.from_numpy(gidx), torch.from_numpy(rois),
                           out_size)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want > 0).mean() < 0.9 and (want == 0).any()
    assert torch.equal(got, crop_resize_mask_plain(
        torch.from_numpy(masks), torch.from_numpy(boxes),
        torch.from_numpy(gidx), torch.from_numpy(rois), out_size))


def test_gt_masks_ride_in_gt_instances():
    """``GTInstances.pad(masks=)`` and ``pad_gt_masks`` as erd_tpu's."""
    crops = gt_crops(np.random.RandomState(1), 3)
    boxes = [[0, 0, 4, 4], [1, 1, 5, 5], [2, 2, 6, 6]]
    got = GTInstances.pad(boxes, [0, 1, 2], 2, masks=crops)
    want = JGTInstances.pad(boxes, [0, 1, 2], 2, masks=crops)
    np.testing.assert_array_equal(got.masks, want.masks)
    assert got.masks.dtype == np.uint8 and got.masks.shape == (2, 56, 56)
    assert GTInstances.pad(boxes, [0, 1, 2], 4).masks is None
    from erd_tpu.data.masks import pad_gt_masks as j_pad_gt_masks
    np.testing.assert_array_equal(pad_gt_masks(crops, 5),
                                  j_pad_gt_masks(crops, 5))


def test_mask_loss_matches_jax():
    rs = np.random.RandomState(5)
    logits = rs.randn(12, 28, 28, 4).astype(np.float32) * 3
    logits[0, :3, :3] = 0.0  # BCE's kink at 0
    targets = rs.rand(12, 28, 28).astype(np.float32)
    labels = rs.randint(0, 5, 12)  # 4 = background, clipped
    is_pos = (rs.rand(12) < 0.5).astype(np.float32)
    is_pos[0] = 1
    want, (gl,) = jax.value_and_grad(j_mask_loss, argnums=(0,))(
        jnp.asarray(logits), targets, labels, is_pos)
    tl = torch.from_numpy(np.ascontiguousarray(
        logits.transpose(0, 3, 1, 2))).requires_grad_()
    got = mask_loss(tl, torch.from_numpy(targets), torch.from_numpy(labels),
                    torch.from_numpy(is_pos).bool())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    np.testing.assert_allclose(tl.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gl), rtol=1e-5, atol=1e-9)
    zero = mask_loss(tl, torch.from_numpy(targets), torch.from_numpy(labels),
                     torch.zeros(12, dtype=torch.bool))
    assert zero.item() == 0.0


# --------------------------------------------------- point_sample backward
def point_forms(rs):
    """PointRend's four training call forms at small sizes: (maps NHWC,
    points, channels-last in the port): the uncertainty (C = 1) and target
    (C = 1) calls on (R, 14, 14) maps at the 588 / 196 points, the coarse
    logits (C = 4, channels-last) at 196 points, P2 (B, 24, 32, 8) at the
    points of 6 RoIs an image, some off the map."""
    pts = lambda *s: rs.uniform(-0.05, 1.05, s + (2,)).astype(  # noqa
        np.float32)
    return {'uncertainty': (rs.randn(6, 14, 14, 1), pts(6, 588), False),
            'coarse': (rs.randn(6, 14, 14, 4), pts(6, 196), True),
            'fine': (rs.randn(2, 24, 32, 8), pts(2, 6 * 196), False),
            'targets': (rs.rand(6, 14, 14, 1), pts(6, 196), False)}


@pytest.mark.parametrize('form', ['uncertainty', 'coarse', 'fine',
                                  'targets'])
def test_point_sample_backward_matches_jax_vjp(form):
    maps, pts, channels_last = point_forms(np.random.RandomState(8))[form]
    maps = maps.astype(np.float32)
    _, vjp = jax.vjp(lambda m: jax.vmap(j_point_sample)(m, pts),
                     jnp.asarray(maps))
    g = np.random.RandomState(9).randn(*pts.shape[:2],
                                       maps.shape[-1]).astype(np.float32)
    want = np.moveaxis(np.asarray(jax.jit(vjp)(jnp.asarray(g))[0]), -1, 1)
    tm = torch.from_numpy(np.ascontiguousarray(np.moveaxis(maps, -1, 1)))
    if channels_last:
        tm = tm.contiguous(memory_format=torch.channels_last)
    tm.requires_grad_()
    out = point_sample(tm, torch.from_numpy(pts))
    out.backward(torch.from_numpy(g))
    assert tm.grad.shape == want.shape and tm.grad.stride() == tm.stride()
    np.testing.assert_allclose(tm.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    plain = point_sample_backward_plain(torch.from_numpy(g),
                                        torch.from_numpy(pts), tm.shape)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_point_sample_passes_gradcheck_and_refuses_point_gradients():
    """Finite differences in float64 on the plain path (points inside, on
    the edges and off the map); points that require a gradient raise while
    grad is on; a bf16 map's gradient is the float32 sum rounded once."""
    rs = np.random.RandomState(10)
    maps = torch.from_numpy(rs.randn(2, 3, 5, 6)).requires_grad_()
    pts = torch.from_numpy(rs.uniform(-0.2, 1.2, (2, 7, 2)))
    assert torch.autograd.gradcheck(lambda m: point_sample(m, pts), (maps,))
    with pytest.raises(ValueError, match='no gradient'):
        point_sample(maps, pts.clone().requires_grad_())
    with torch.no_grad():
        point_sample(maps, pts.clone().requires_grad_())
    mb = maps.detach().float().bfloat16().requires_grad_()
    g = torch.randn(2, 7, 3, generator=torch.Generator().manual_seed(0))
    point_sample(mb, pts.float()).backward(g)
    want = point_sample_backward(g, pts.float(), tuple(mb.shape),
                                 dtype=torch.bfloat16)
    assert mb.grad.dtype == torch.bfloat16 and torch.equal(mb.grad, want)
    assert torch.equal(want, point_sample_backward_plain(
        g, pts.float(), tuple(mb.shape)).bfloat16())


# ------------------------------------------------- importance sampling
def test_importance_points_are_erd_tpus_on_its_draws():
    """PointRend's pick of the 147 most uncertain of 588 draws on erd_tpu's
    own keys, with ties (coarse logits on a 1/8 grid, so equal
    uncertainties are exact ties) broken lowest index first, as
    ``lax.top_k``."""
    from erd_tpu_torch.models.detectors.point_rend import topk_stable
    from erd_tpu_torch.ops.misc import take_rows
    rs = np.random.RandomState(11)
    coarse_at = np.round(rs.randn(8, 14, 14) * 8).astype(np.float32) / 8
    rnd, rnd2 = point_draws(7, 8)

    def jfn(c, r, r2):
        unc = -jnp.abs(jax.vmap(lambda m, p: j_point_sample(
            m[..., None], p)[..., 0])(c, r))
        _, idx = jax.lax.top_k(unc, 147)
        return jnp.concatenate([jnp.take_along_axis(
            r, idx[..., None].repeat(2, -1), axis=1), r2], axis=1)
    want = np.asarray(jax.jit(jfn)(coarse_at, rnd.numpy(), rnd2.numpy()))
    unc = -point_sample(torch.from_numpy(coarse_at)[:, None], rnd)[
        ..., 0].abs()
    _, idx = topk_stable(unc, 147)
    got = torch.cat([take_rows(rnd, idx), rnd2], 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((unc[:, :, None] == unc[:, None, :]).sum()) > 8 * 588


# ------------------------------------------------- the whole networks
def test_loss_and_every_gradient_match_jax(train_run, monkeypatch):
    """The loss dict and every parameter gradient of the depth-18 network
    against erd_tpu's value_and_grad, on the same proposals, samples,
    draws and (PointRend) importance picks."""
    kind, run = train_run
    det = with_samples(build_detector(small_cfg(Config, kind).model))
    net = det.build_net()
    net.load_state_dict(params_from_jax(run['variables']), strict=True)
    swaps = use_jax_proposals(monkeypatch, run, 1e-4)
    seen = record_samples(monkeypatch)
    picks = use_jax_picks(monkeypatch, run['picks']) \
        if kind == 'point_rend' else None
    losses = det.loss(net, port_batch(), draws=run['draws'])
    assert len(swaps) == 1
    assert_same_samples(seen[0], run['samples'])
    assert set(losses) == set(run['losses'])
    extra = {'mask_rcnn': ['loss_mask'],
             'point_rend': ['loss_mask', 'loss_point']}[kind]
    assert list(losses)[-len(extra):] == extra
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run['losses'][k], rtol=1e-5,
                                   err_msg=k)
        assert v.item() > 0, k
    if picks is not None:
        assert len(picks) == 1 and picks[0] <= 1e-3 * run['picks'].size, \
            picks
    sum(losses.values()).backward()
    n = assert_grad_norms(net, run['grads'])
    assert n == sum(1 for p in net.parameters() if p.requires_grad)


def test_mask_loss_needs_gt_masks():
    """A batch without gt masks raises, as erd_tpu's assert does."""
    det = with_samples(build_detector(small_cfg(Config, 'mask_rcnn').model))
    net = det.init(seed=1, device='cpu')
    batch = port_batch()
    batch['gt'] = dataclasses.replace(batch['gt'], masks=None)
    with pytest.raises(ValueError, match='needs gt masks'):
        det.loss(net, batch)


@pytest.mark.parametrize('kind', ['mask_rcnn', 'point_rend'])
def test_fit_two_steps_from_the_config(kind):
    """build_trainer + fit of the config (depth 18) for two steps on the
    CPU: finite losses, the frozen stem and layer1 unchanged, every
    trainable weight moved; without ``draws`` PointRend draws its points
    from a generator seeded with the batch's img_id sum."""
    cfg = small_cfg(Config, kind)
    cfg.train_cfg.epochs = 1
    cfg.optim.update(lr=0.16, warmup_factor=1.0)
    det = with_samples(build_detector(cfg.model))
    net = det.init(seed=3, device='cpu')
    start = copy.deepcopy(net.state_dict())
    rec = Recorder()
    trainer = build_trainer(cfg, det, OneBatchLoader(port_batch(), 2),
                            device='cpu')
    trainer.hooks.append(rec)
    trainer.fit(net)
    assert len(rec.losses) == 2
    assert 'loss_mask' in rec.losses[0]
    for losses in rec.losses:
        assert all(np.isfinite(v) for v in losses.values()), losses
    frozen = resnet_frozen_paths(1)
    trainable = {n for n, p in net.named_parameters() if p.requires_grad}
    for name, value in net.state_dict().items():
        moved = not torch.equal(value, start[name])
        assert not (name.startswith(frozen) and moved), name
        if name in trainable and value.dim() > 1:
            assert moved, name
    if kind == 'point_rend':
        ids = torch.tensor(IMG_IDS)
        a = det.train_draws(ids, 2, 10, 20, 'cpu')
        b = det.train_draws(ids + 1, 2, 10, 20, 'cpu')
        assert [tuple(d.shape) for d in a[4:]] == [(128, 588, 2),
                                                   (128, 49, 2)]
        assert not any(torch.equal(x, y) for x, y in zip(a, b))
