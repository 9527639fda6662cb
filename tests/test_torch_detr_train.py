"""Port parity of Deformable DETR training on the CPU: the multi-scale
deformable-attention backward, the Hungarian matcher, the sigmoid focal
loss, the Deformable DETR set loss, the loss and every gradient of the
network against erd_tpu, and ``build_trainer`` + ``fit``.

The networks are ``tests/test_torch_detr.py``'s (ResNet-18, 4 classes, 20
queries, 64x96 canvas, float32, the sampling weights arranged on both sides
by ``arrange_sampling`` so that locations are fractional and reach off the
map), B = 2 images with 3 and 2 gt boxes in MAX_GT = 4 slots. Inputs are
made with numpy from a seed on a 1/64 grid, which float32 holds exactly.
Tolerances, each with its reason:
- the sampling backward's plain version against jax.vjp of erd_tpu's
  ``ms_deform_attn_sample``: rtol 1e-5 with atol 1e-6 * max|g| (the
  scatter's sums and the channel sums in another order);
- ``gradcheck`` of the autograd Function in float64: its own defaults;
- the matcher: exactly equal;
- the focal and the set losses from identical inputs: rtol 1e-5, their
  input gradients rtol 1e-5 with atol 1e-6 * max|g|;
- from identical ChannelMapper features (erd_tpu's, captured with its loss)
  and through the whole network, the port in float64 (its weights
  erd_tpu's float32 ones) against erd_tpu in float32: the loss dict rtol
  1e-5; the gradients of the features and of all trainable parameters
  together within ||diff|| <= 1e-3 * ||g||, and of each tensor within
  5e-3 * ||g|| + 1e-7 * (the largest ||g|| of any tensor). Not element by
  element: a ReLU whose float32 pre-activation lies within rounding of 0
  routes its gradient either way. Such a kink moves the gradients below it
  by up to 6e-4 of their norm in erd_tpu's float32 (DINO's backbone and
  encoder_0; the whole gradient 9e-5), and by up to 1.7e-3 in the port's
  float32 (Deformable DETR's encoder_3 ffn1 has one at -2.8e-8, +2.4e-8
  in float64), which is why the port runs in float64 here. The second
  term covers the attention key biases, whose gradient is 0 but for
  rounding (the softmax ignores a shift common to all keys). The frozen
  stem and layer1 take no gradient in the port (requires_grad=False);
  erd_tpu masks their updates in the optimizer instead. ``fit`` runs in
  float32.
"""
import copy
import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erd_tpu.task.hungarian as j_hungarian_module
from erd_tpu.losses.focal import sigmoid_focal_loss as j_focal
from erd_tpu.models.detectors.deformable_detr import \
    DeformableDETRDetector as JDeformableDETR
from erd_tpu.models.detectors.dino import DINODetector as JDINO
from erd_tpu.models.heads.deformable_detr_head import \
    DeformableDETRHeadNet as JDeformableDETRHead
from erd_tpu.models.heads.deformable_detr_head import \
    deformable_detr_loss as j_deformable_detr_loss
from erd_tpu.models.heads.dino_head import DINOHeadNet as JDINOHead
from erd_tpu.models.heads.dino_head import \
    make_dn_attn_mask as j_make_dn_attn_mask
from erd_tpu.ops.ms_deform_attn import ms_deform_attn_sample
from erd_tpu.structures.det_sample import GTInstances as JGTInstances
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector, build_trainer
from erd_tpu_torch.config import Config
from erd_tpu_torch.engine import resnet_frozen_paths
from erd_tpu_torch.losses import sigmoid_focal_loss
from erd_tpu_torch.models import DeformableDETRDetector, DINODetector
from erd_tpu_torch.models.heads.deformable_detr_head import \
    deformable_detr_loss
from erd_tpu_torch.models.weight_import import params_from_jax
from erd_tpu_torch.ops import (make_level_start_index, ms_deform_attn,
                               ms_deform_attn_backward,
                               ms_deform_attn_backward_plain)
from erd_tpu_torch.structures import GTInstances, ImageMeta, stack_to
from erd_tpu_torch.task import hungarian_match
from tests.test_torch_detr import CANVAS, CONFIGS, NUM_CLASSES, \
    NUM_QUERIES, arrange_both, to_numpy
from tests.test_torch_train import OneBatchLoader, Recorder

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_GT = 4
IMG_IDS = (3, 5)
GTS = [([[10, 8, 60, 50], [30, 4, 90, 40], [40, 30, 94, 62]], [1, 3, 0]),
       ([[4, 6, 40, 44], [44, 20, 90, 60]], [2, 1])]
# power-of-two level widths: cell centres (k + 0.5) / W lie on the 1/64 grid
GRID_SHAPES = [(8, 16), (4, 8), (2, 4), (1, 2)]


def grid(a, step=64):
    """``a`` rounded to multiples of 1 / step, float32 (exact)."""
    return (np.round(np.asarray(a) * step) / step).astype(np.float32)


def numpy_batch():
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (2,) + CANVAS + (3,), dtype=np.uint8)
    gt = [JGTInstances.pad(np.asarray(b, np.float32), lab, MAX_GT)
          for b, lab in GTS]
    meta = [JImageMeta.make(CANVAS, CANVAS, (1.0, 1.0), img_id=i)
            for i in IMG_IDS]
    return images, gt, meta


def jax_batch():
    images, gt, meta = numpy_batch()
    stack = lambda items: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.asarray(np.stack(xs)), *items)
    return dict(images=jnp.asarray(images), gt=stack(gt), meta=stack(meta))


def port_batch():
    images, gt, meta = numpy_batch()
    return dict(
        images=torch.from_numpy(images),
        gt=stack_to([GTInstances(bboxes=g.bboxes, labels=g.labels,
                                 mask=g.mask) for g in gt], 'cpu'),
        meta=stack_to([ImageMeta.make(CANVAS, CANVAS, (1.0, 1.0), img_id=i)
                       for i in IMG_IDS], 'cpu'))


def build(kind):
    """``tests/test_torch_detr.py``'s models (erd_tpu's ``init`` compiled
    by ``compile_fast``), DINO's zero-initialised ``fc_reg`` kernel
    replaced by a seeded one on both sides (with zeros every decoder layer
    would predict the same boxes and the regression MLP would take no
    gradient)."""
    jcls, cls = ((JDINO, DINODetector) if kind == 'dino' else
                 (JDeformableDETR, DeformableDETRDetector))
    jdet = jcls(num_classes=NUM_CLASSES, depth=18, num_queries=NUM_QUERIES)
    args = [jax.random.PRNGKey(0),
            jdet.preprocessor(jnp.zeros((1,) + CANVAS + (3,), jnp.uint8))]
    if kind == 'dino':  # DINODetector.init's dummy denoising queries
        d = 2 * MAX_GT * jdet.train_cfg.dn_groups
        args += [jnp.zeros((1, d), jnp.int32),
                 jnp.full((1, d, 4), 0.5, jnp.float32),
                 j_make_dn_attn_mask(d, NUM_QUERIES, 3)]
    variables = to_numpy(compile_fast(jdet.net.init, *args))
    if kind == 'dino':
        k = variables['params']['bbox_head']['fc_reg']['kernel']
        k[...] = np.random.RandomState(9).normal(0, 0.1, k.shape)
    det = cls(num_classes=NUM_CLASSES, depth=18, num_queries=NUM_QUERIES)
    net = det.init(seed=0, device='cpu')
    arrange_both(net.bbox_head, variables['params']['bbox_head'])
    net.load_state_dict(params_from_jax(variables), strict=True)
    return dict(jdet=jdet, variables=variables, det=det, net=net)


def jax_dn_draws(id_sum, b, num_dn, num_classes=NUM_CLASSES):
    """erd_tpu's four denoising draws (``make_dn_queries``'s split of
    ``fold_in(PRNGKey(7), img_id.sum())``) as torch tensors."""
    r1, r2, r3, r4 = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(7), id_sum), 4)
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(r1, (b, num_dn)),
        jax.random.randint(r2, (b, num_dn), 0, num_classes),
        jax.random.randint(r3, (b, num_dn, 4), 0, 2),
        jax.random.uniform(r4, (b, num_dn, 4))))


def compile_fast(fn, *args):
    """``fn(*args)`` jitted with XLA's backend optimisation off: a third
    less compile time for the whole network's gradient."""
    return jax.jit(fn).lower(*args).compile(
        {'xla_backend_optimization_level': 0})(*args)


def jax_train_run(kind, m):
    """erd_tpu's loss of the batch, its gradients in the parameters and in
    the ChannelMapper features (a zero probe added to each level, found by
    intercepting the head's call), and the features themselves."""
    jdet, variables = m['jdet'], m['variables']
    head_cls = JDINOHead if kind == 'dino' else JDeformableDETRHead
    consts = {k: v for k, v in variables.items() if k != 'params'}
    batch = jax_batch()
    shapes = [(2, h, w, 256) for h, w in
              ((8, 12), (4, 6), (2, 3), (1, 2))]

    def total(params, probes):
        captured = []

        def interceptor(next_fun, args, kwargs, context):
            if isinstance(context.module, head_cls) and \
                    context.method_name == '__call__':
                feats = [f + p for f, p in zip(args[0], probes)]
                captured.append(feats)
                args = (feats,) + tuple(args[1:])
            return next_fun(*args, **kwargs)
        with fnn.intercept_methods(interceptor):
            losses = jdet.loss({'params': params, **consts}, batch)
        return sum(losses.values()), (losses, captured[0])

    probes = [jnp.zeros(s, jnp.float32) for s in shapes]
    (_, (losses, feats)), (grads, feat_grads) = compile_fast(
        jax.value_and_grad(total, argnums=(0, 1), has_aux=True),
        variables['params'], probes)
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads=params_from_jax(to_numpy({'params': grads})),
                feats=[np.asarray(f) for f in feats],
                feat_grads=[np.asarray(g) for g in feat_grads])


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, 1)))


def grad_error(got, want):
    return float(np.linalg.norm(got - want))


def float64_copy(m):
    """The port's detector and network in float64, its weights erd_tpu's
    float32 values."""
    return (dataclasses.replace(m['det'], compute_dtype=torch.float64),
            copy.deepcopy(m['net']).double())


def assert_grads(named, want, prefix=''):
    """The trainable parameters' .grad against ``want`` (a
    state-dict-shaped map): all together within ||diff|| <= 1e-3 * ||g||,
    each within 5e-3 * ||g|| + 1e-7 * the largest ||g||; frozen ones have
    none. Returns the count checked."""
    frozen = resnet_frozen_paths(1)
    named = [(n, p) for n, p in named if n.startswith(prefix)]
    scale = max(float(want[n].norm()) for n, p in named if p.requires_grad)
    checked, total, total_err = 0, 0.0, 0.0
    for name, p in named:
        if name.startswith(frozen):
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name].numpy()
        err = grad_error(p.grad.numpy(), w)
        assert err <= 5e-3 * np.linalg.norm(w) + 1e-7 * scale, \
            (name, err, float(np.linalg.norm(w)))
        total += float(np.sum(w.astype(np.float64) ** 2))
        total_err += err ** 2
        checked += 1
    assert total_err ** 0.5 <= 1e-3 * total ** 0.5
    return checked


def check_loss_from_feats(m, run, loss_fn):
    """The port's head and loss (float64) on erd_tpu's ChannelMapper
    features: losses, the features' gradients and every head parameter's
    gradient. ``loss_fn(net, feats)`` runs the head and the loss."""
    _, net = float64_copy(m)
    feats = [nchw(f).double().requires_grad_() for f in run['feats']]
    losses = loss_fn(net, feats)
    assert set(losses) == set(run['losses'])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run['losses'][k], rtol=1e-5,
                                   err_msg=k)
    sum(losses.values()).backward()
    for f, w in zip(feats, run['feat_grads']):
        w = np.moveaxis(w, -1, 1)
        assert grad_error(f.grad.numpy(), w) <= 1e-3 * np.linalg.norm(w)
    n = assert_grads(net.named_parameters(), run['grads'], 'bbox_head.')
    assert n == sum(1 for k, p in net.bbox_head.named_parameters()
                    if p.requires_grad)


def check_whole_network(m, run, **kw):
    det, net = float64_copy(m)
    losses = det.loss(net, port_batch(), **kw)
    assert set(losses) == set(run['losses'])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run['losses'][k], rtol=1e-5,
                                   err_msg=k)
    sum(losses.values()).backward()
    n = assert_grads(net.named_parameters(), run['grads'])
    assert n == sum(1 for p in net.parameters() if p.requires_grad)


def small_cfg(kind):
    """The config at depth 18 in float32, 4 classes, 20 queries."""
    cfg = Config.fromfile(os.path.join(ROOT, CONFIGS[kind]))
    cfg.model.update(depth=18, compute_dtype='float32',
                     num_classes=NUM_CLASSES, num_queries=NUM_QUERIES)
    return cfg


def check_fit(kind):
    """build_trainer + fit of the config (depth 18) for two steps on the
    CPU: finite losses, the frozen stem and layer1 unchanged, every
    trainable weight moved."""
    cfg = small_cfg(kind)
    cfg.train_cfg.epochs = 1
    cfg.optim.update(lr=0.01, warmup_factor=1.0)
    det = build_detector(cfg.model)
    assert det.frozen_stages == 1
    net = det.init(seed=3, device='cpu')
    start = copy.deepcopy(net.state_dict())
    rec = Recorder()
    trainer = build_trainer(cfg, det, OneBatchLoader(port_batch(), 2),
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


# ------------------------------------------- deformable attention backward
def sampling_case(rs, shapes, b=2, q=29, heads=8, hd=32, k=4):
    """Values, locations, weights and an output gradient on the 1/64 grid:
    locations in [-0.25, 1.25] (corners off the map), a quarter of the
    samples planted on cell centres (bilinear weights 0 and 1)."""
    n = sum(h * w for h, w in shapes)
    lv = len(shapes)
    vals = grid(rs.randn(b, n, heads, hd))
    loc = grid(rs.uniform(-0.25, 1.25, (b, q, heads, lv, k, 2)))
    centre = rs.rand(b, q, heads, lv, k) < 0.25
    for i, (h, w) in enumerate(shapes):
        for axis, size in ((0, w), (1, h)):
            c = (rs.randint(0, size, centre.shape[:3] + (k,)) + 0.5) / size
            loc[:, :, :, i, :, axis] = np.where(centre[:, :, :, i], c,
                                                loc[:, :, :, i, :, axis])
    weights = grid(rs.rand(b, q, heads, lv, k) / (lv * k))
    g = grid(rs.randn(b, q, heads, hd))
    return vals, loc.astype(np.float32), weights, g


def sampling_stats(shapes, loc):
    """(share of samples with a fractional bilinear weight, exactly on an
    integer point, with a corner off the map)."""
    frac = exact = off = total = 0
    for i, (h, w) in enumerate(shapes):
        xs = loc[:, :, :, i, :, 0] * w - 0.5
        ys = loc[:, :, :, i, :, 1] * h - 0.5
        x0, y0 = np.floor(xs), np.floor(ys)
        total += xs.size
        frac += int(((xs != x0) | (ys != y0)).sum())
        exact += int(((xs == x0) & (ys == y0)).sum())
        off += int(((x0 < 0) | (x0 + 1 > w - 1) | (y0 < 0) |
                    (y0 + 1 > h - 1)).sum())
    return frac / total, exact / total, off / total


@pytest.mark.parametrize('levels', [4, 1])
def test_ms_deform_attn_backward_plain_matches_jax_vjp(levels):
    rs = np.random.RandomState(levels)
    shapes = GRID_SHAPES[:levels]
    vals, loc, weights, g = sampling_case(rs, shapes)
    frac, exact, off = sampling_stats(shapes, loc)
    assert frac >= 0.5 and exact > 0.05 and off >= 0.01
    starts = make_level_start_index(shapes)
    heads, hd = vals.shape[2:]

    def fn(v, lc, wt):
        def one(vi, li, wi):
            return ms_deform_attn_sample(
                [vi[starts[j]:starts[j + 1]].reshape(h, w, heads, hd)
                 for j, (h, w) in enumerate(shapes)], li, wi)
        return jax.vmap(one)(v, lc, wt)
    _, vjp = jax.vjp(fn, jnp.asarray(vals), jnp.asarray(loc),
                     jnp.asarray(weights))
    want = jax.jit(vjp)(jnp.asarray(g))
    got = ms_deform_attn_backward_plain(
        *(torch.from_numpy(a) for a in (vals,)), shapes,
        torch.from_numpy(loc), torch.from_numpy(weights),
        torch.from_numpy(g))
    for name, a, w in zip(('values', 'locations', 'weights'), got, want):
        w = np.asarray(w)
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
    # on the CPU the wrapper is the plain version; bf16 weights take a bf16
    # gradient (the float32 one rounded)
    args = (torch.from_numpy(vals), shapes, torch.from_numpy(loc),
            torch.from_numpy(weights), torch.from_numpy(g))
    for a, b in zip(ms_deform_attn_backward(*args), got):
        assert torch.equal(a, b)
    wb = args[3].bfloat16()
    gb = ms_deform_attn_backward(*args[:3], wb, args[4])
    assert gb[2].dtype == torch.bfloat16
    assert torch.equal(gb[2], ms_deform_attn_backward_plain(
        *args[:3], wb.float(), args[4])[2].bfloat16())
    with pytest.raises(ValueError, match='grad'):
        ms_deform_attn_backward(*args[:4], args[4][:, 1:])


def test_ms_deform_attn_autograd_runs_its_backward():
    """The autograd Function's gradients are the backward's (values,
    locations, and bf16 weights in bf16); no kernel counts on the CPU."""
    rs = np.random.RandomState(7)
    vals, loc, weights, g = sampling_case(rs, GRID_SHAPES, q=5)
    v = torch.from_numpy(vals).requires_grad_()
    lc = torch.from_numpy(loc).requires_grad_()
    w = torch.from_numpy(weights).bfloat16().requires_grad_()
    launches = (ms_deform_attn.launches, ms_deform_attn_backward.launches)
    out = ms_deform_attn(v, GRID_SHAPES, lc, w)
    assert out.grad_fn is not None and out.dtype == torch.float32
    out.backward(torch.from_numpy(g))
    want = ms_deform_attn_backward_plain(
        v.detach(), GRID_SHAPES, lc.detach(), w.detach().float(),
        torch.from_numpy(g))
    assert torch.equal(v.grad, want[0]) and torch.equal(lc.grad, want[1])
    assert w.grad.dtype == torch.bfloat16 and \
        torch.equal(w.grad, want[2].bfloat16())
    assert (ms_deform_attn.launches,
            ms_deform_attn_backward.launches) == launches


def test_ms_deform_attn_function_passes_gradcheck():
    """Finite differences in float64 of the Function on the plain path:
    two levels, locations reaching off the maps."""
    rs = np.random.RandomState(8)
    shapes = [(3, 4), (2, 2)]
    v = torch.from_numpy(rs.randn(1, 16, 2, 3)).requires_grad_()
    lc = torch.from_numpy(rs.uniform(-0.2, 1.2, (1, 3, 2, 2, 2, 2)))
    w = torch.from_numpy(rs.rand(1, 3, 2, 2, 2))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ms_deform_attn(a, shapes, b, c),
        (v, lc.requires_grad_(), w.requires_grad_()))


# the sampling backward calls of one bs-16, 800x1344 step of each DETR
# config: the encoder's (Q = every token, 22323) and the decoder's (DINO's
# 900 queries and 96 denoising queries, Deformable DETR's 300), 6 each
DETR_LEVELS_800 = [(100, 168), (50, 84), (25, 42), (13, 21)]
DETR_STEP_QUERIES = {'dino': (22323, 996), 'deformable_detr': (22323, 300)}


@pytest.mark.parametrize('kind', sorted(DETR_STEP_QUERIES))
def test_ms_deform_attn_backward_run_fits_every_call_of_a_step(kind):
    """The backward kernel's blocks for each call shape of a bs-16 step:
    runs of a multiple of 8 queries, RUN at the encoder and 8 at the
    decoders' small Q, 132 blocks or more, every query in one block."""
    from erd_tpu_torch.ops.ms_deform_attn import (RUN,
                                                  ms_deform_attn_backward_run)
    assert sum(h * w for h, w in DETR_LEVELS_800) == 22323
    encoder, decoder = DETR_STEP_QUERIES[kind]
    assert ms_deform_attn_backward_run(16, encoder, 8) == RUN
    assert ms_deform_attn_backward_run(16, decoder, 8) == 8
    for q in DETR_STEP_QUERIES[kind]:
        run = ms_deform_attn_backward_run(16, q, 8)
        runs = -(-q // run)
        assert run % 8 == 0 and 8 <= run <= RUN
        assert 16 * 8 * runs >= 132
        assert run * (runs - 1) < q <= run * runs


# ---------------------------------------------------------------- matcher
def test_hungarian_match_matches_jax():
    """Random costs with ties on the 1/64 grid, padded gt columns, an image
    with no gt and one with more gts than a few queries could take."""
    rs = np.random.RandomState(3)
    b, q, g = 4, 12, 5
    cost = grid(rs.randn(b, q, g) * 3, 8)
    mask = np.ones((b, g), bool)
    mask[1, 3:] = False
    mask[2] = False  # no gt
    want = np.asarray(jax.jit(j_hungarian_module.hungarian_match)(
        jnp.asarray(cost), jnp.asarray(mask)))
    got = hungarian_match(torch.from_numpy(cost).requires_grad_(),
                          torch.from_numpy(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[2] == -1).all() and (got[1] >= 0).sum() == 3
    assert sorted(got[0][got[0] >= 0].tolist()) == list(range(g))


# ----------------------------------------------------------------- losses
def test_sigmoid_focal_loss_matches_jax():
    """Integer labels (background = C) with row weights and avg_factor,
    binary targets, and the 'none' reduction; input gradients."""
    rs = np.random.RandomState(4)
    pred = grid(rs.randn(40, 6) * 3)
    labels = rs.randint(0, 7, 40)
    weight = grid(rs.rand(40))
    onehot = (rs.rand(40, 6) > 0.7).astype(np.float32)
    for kw, target in ((dict(weight=weight, avg_factor=7.0), labels),
                       ({}, onehot), (dict(reduction='none'), labels)):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        want, jgrad = jax.value_and_grad(
            lambda p: j_focal(p, jnp.asarray(target), **jkw).sum())(
            jnp.asarray(pred))
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        p = torch.from_numpy(pred).requires_grad_()
        got = sigmoid_focal_loss(p, torch.from_numpy(target), **tkw).sum()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        got.backward()
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(p.grad.numpy(), jgrad, rtol=1e-5,
                                   atol=1e-6 * np.abs(jgrad).max())


def test_deformable_detr_loss_matches_jax():
    """The per-layer set losses of 3 layers from identical outputs, and
    their gradients in the outputs. The boxes lie on a 1/4096 grid: on the
    1/64 grid box edges meet gt edges exactly, where erd_tpu's
    maximum(., 0) and the port's clamp split a gradient differently."""
    rs = np.random.RandomState(5)
    _, gt, _ = numpy_batch()
    jgt = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *gt)
    layers, q = 3, 15
    cls = grid(rs.randn(layers, 2, q, NUM_CLASSES) * 2)
    boxes = grid(rs.uniform(0.1, 0.6, (layers, 2, q, 4)), 4096)
    def jtotal(c, bx):
        parts = j_deformable_detr_loss(c, bx, jgt, CANVAS, NUM_CLASSES)
        return sum(parts.values()), parts
    (want, parts), (gc, gb) = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True))(jnp.asarray(cls),
                                               jnp.asarray(boxes))
    c = torch.from_numpy(cls).requires_grad_()
    bx = torch.from_numpy(boxes).requires_grad_()
    tgt = port_batch()['gt']
    got = deformable_detr_loss(c, bx, tgt, CANVAS, NUM_CLASSES)
    assert set(got) == set(parts)
    for k in parts:
        np.testing.assert_allclose(got[k].item(), float(parts[k]),
                                   rtol=1e-5, err_msg=k)
    total = sum(got.values())
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    total.backward()
    for t, w in ((c, gc), (bx, gb)):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
    # the caller's matches replace the solver's
    same = deformable_detr_loss(
        c, bx, tgt, CANVAS, NUM_CLASSES,
        matches=[torch.full((2, q), -1)] * layers)
    assert float(same['loss_bbox'].detach()) == 0.0


# ------------------------------------------------------ the whole slice
@pytest.fixture(scope='module')
def ddetr():
    m = build('deformable_detr')
    m['run'] = jax_train_run('deformable_detr', m)
    return m


def test_loss_from_feats_matches_jax(ddetr):
    det = ddetr['det']
    gt = port_batch()['gt']

    def loss_fn(net, feats):
        all_cls, all_boxes = net.bbox_head(feats)
        return deformable_detr_loss(all_cls, all_boxes, gt, CANVAS,
                                    det.num_classes, det.train_cfg)
    check_loss_from_feats(ddetr, ddetr['run'], loss_fn)


def test_whole_network_loss_and_grads_match_jax(ddetr):
    check_whole_network(ddetr, ddetr['run'])


def test_fit_two_steps_from_the_deformable_detr_config():
    losses = check_fit('deformable_detr')
    assert set(losses[0]) == {f'loss_{n}{s}' for n in ('cls', 'bbox', 'giou')
                              for s in ['', *(f'_aux{i}' for i in range(5))]}
