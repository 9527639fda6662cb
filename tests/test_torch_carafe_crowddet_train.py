"""Port parity of FPN-CARAFE Faster R-CNN and CrowdDet training on the CPU:
CARAFE's backward, CrowdDet's EMD loss, the loss and gradients of both
networks against erd_tpu, and ``build_trainer`` + ``fit`` of both configs.

The networks, batches and erd_tpu keys are tests/test_torch_frcnn_train.py's
(depth 18, float32, B = 2 in a 96x128 canvas; CARAFE's content encoders
arranged: erd_tpu's N(0, 0.001) init weights every tap ~1/25). Tolerances,
each with its reason:
- CARAFE's backward (the plain version, written out in float32) against
  jax.vjp of erd_tpu's shuffle + softmax + reassembly: dx and dlogits
  within 1e-5 * max|g| in float32 (sums over the channels and the taps in
  another order); in bf16 within 2e-2 * max|g| (the same float32 sums,
  rounded once to bf16 on both sides, one ulp apart where they straddle a
  rounding boundary);
- the EMD loss from identical head outputs and samples: rtol 1e-6, its
  gradients in the head outputs rtol 1e-5 with atol 1e-6 * max|g|;
- the loss from identical FPN features and the whole network: as
  tests/test_torch_frcnn_train.py.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erd_tpu.models.detectors.crowddet as j_crowddet_module
from erd_tpu.apis.build import build_detector as j_build_detector
from erd_tpu.config import Config as JConfig
from erd_tpu_torch.apis import build_detector
from erd_tpu_torch.config import Config
from erd_tpu_torch.ops import carafe, carafe_plain
from erd_tpu_torch.ops.carafe import carafe_backward, carafe_backward_plain
from erd_tpu_torch.structures import bbox_overlaps
from tests.test_torch_carafe_crowddet import grid, j_carafe_pack_tail
from tests.test_torch_frcnn_train import (CANVAS, MAX_GT, check_fit,
                                          check_loss_from_feats,
                                          check_whole_network, jax_batch,
                                          jax_draws, jax_train_run,
                                          port_batch, small_cfg)

torch.set_num_threads(2)

KINDS = ['carafe', 'crowddet']


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------- CARAFE
@pytest.mark.parametrize('dtype,hw', [('float32', (7, 9)),
                                      ('float32', (5, 12)),
                                      ('float32', (1, 3)),
                                      ('bfloat16', (6, 7))])
def test_carafe_backward_plain_matches_jax_vjp(dtype, hw):
    """Peaked taps (logits N(0, 2^2)), odd sizes, one and several rows."""
    rs = np.random.RandomState(hw[0] * 13 + hw[1])
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    x = grid(rs, (2, *hw, 16), 1.5)
    logits = grid(rs, (2, *hw, 100), 2.0)
    g = grid(rs, (2, 2 * hw[0], 2 * hw[1], 16))
    xj, lj, gj = (jnp.asarray(a, jdtype) for a in (x, logits, g))
    _, vjp = jax.vjp(lambda a, b: j_carafe_pack_tail(a, b)[1], xj, lj)
    want_x, want_l = jax.jit(vjp)(gj)
    tx, tl, tg = (torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(jnp.asarray(a, jdtype).astype(jnp.float32)),
                    -1, 1))).to(tdtype) for a in (x, logits, g))
    dx, dl = carafe_backward_plain(tx, tl, tg)
    assert dx.dtype == tdtype and dl.dtype == tdtype
    rel = 2e-2 if dtype == 'bfloat16' else 1e-5
    for got, want in ((dx, want_x), (dl, want_l)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(nhwc(got), want, rtol=0,
                                   atol=rel * np.abs(want).max())


def test_carafe_autograd_runs_its_backward():
    """``carafe`` carries both gradients through ``carafe_backward``; the
    explicit plain backward agrees with autograd of ``carafe_plain``
    within 1e-5 * max|g| (another summation order)."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(grid(rs, (2, 8, 5, 6))).requires_grad_()
    lg = torch.from_numpy(grid(rs, (2, 100, 5, 6), 2.0)).requires_grad_()
    g = torch.from_numpy(grid(rs, (2, 8, 10, 12)))
    out = carafe(x, lg)
    out.backward(g)
    dx, dl = carafe_backward(x.detach(), lg.detach(), g)
    assert torch.equal(x.grad, dx) and torch.equal(lg.grad, dl)
    ax, al = torch.autograd.grad(carafe_plain(x, lg), (x, lg), g)
    for got, want in ((dx, ax), (dl, al)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_carafe_function_passes_gradcheck():
    """Finite differences of ``carafe`` in x and the logits, float64, on the
    plain path, at 2x3 with the zero padding at every border."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 2, 3, generator=gen, dtype=torch.float64)
    lg = torch.randn(1, 100, 2, 3, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        carafe, (x.requires_grad_(), lg.requires_grad_()))


# -------------------------------------------------------------- EMD loss
def test_crowddet_emd_loss_matches_jax():
    """erd_tpu's CrowdDet loss with its first stage, proposals and head
    replaced by given tensors, against the port's ``rcnn_losses`` on the
    same samples and head outputs."""
    jdet = j_build_detector(small_cfg(JConfig, 'crowddet').model)
    det = build_detector(small_cfg(Config, 'crowddet').model)
    rs = np.random.RandomState(11)
    r = 600  # candidates >= the 384 negative slots: 512 samples an image
    xy = rs.uniform(0, 100, (2, r, 2))
    props = np.concatenate([xy, xy + rs.uniform(8, 70, (2, r, 2))],
                           -1).astype(np.float32)
    batch = jax_batch('crowddet')
    gtb = np.asarray(batch['gt'].bboxes)
    for i in range(2):  # proposals over pairs of gts, for two-gt slots
        n = int(np.asarray(batch['gt'].mask[i]).sum())
        props[i, :30] = gtb[i, rs.randint(n, size=30)] + \
            rs.normal(0, 6, (30, 4))
    pmask = rs.rand(2, r) > 0.05
    s = jdet.rcnn_train_cfg.num_samples
    cls2 = (rs.randn(2 * s, 2, 2) * 2).astype(np.float32)
    reg2 = rs.randn(2 * s, 2, 4).astype(np.float32)
    ctx = jdet.anchor_context(CANVAS)
    n_anchors = int(ctx.anchors.shape[0])
    shapes = [(2, h, w, 3) for h, w in ctx.featmap_sizes]

    def jloss(c2, r2):
        def first_stage(v, images):
            feats = [jnp.zeros((2, h, w, 4)) for _, h, w, _ in shapes]
            return (feats, [jnp.zeros(sh) for sh in shapes],
                    [jnp.zeros(sh[:3] + (12,)) for sh in shapes])
        net = jdet.net

        def head(v, x, method=None):
            assert method == 'roi_forward'
            return c2 + 0 * x.sum(), r2
        saved = (j_crowddet_module.rpn_proposals,
                 j_crowddet_module.multilevel_roi_align)
        j_crowddet_module.rpn_proposals = lambda *a, **k: (
            jnp.asarray(props), None, jnp.asarray(pmask))
        j_crowddet_module.multilevel_roi_align = \
            lambda f, rr: jnp.zeros((rr.shape[0], 7, 7, 4))
        jdet._feats_and_rpn = first_stage
        jdet.net = SimpleNamespace(apply=head)
        try:
            out = jdet.loss({'params': {}}, batch)
        finally:
            (j_crowddet_module.rpn_proposals,
             j_crowddet_module.multilevel_roi_align) = saved
            del jdet._feats_and_rpn
            jdet.net = net
        return out['loss_emd'], out
    (_, want), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(cls2),
                                               jnp.asarray(reg2))

    from erd_tpu_torch.models.heads.bbox_head import rcnn_sample
    draws = jax_draws(8, 2, n_anchors, r + MAX_GT)
    tb = port_batch('crowddet')
    samples = rcnn_sample(torch.from_numpy(props), torch.from_numpy(pmask),
                          tb['gt'], 1, det.rcnn_coder, draws[2], draws[3],
                          det.rcnn_train_cfg)
    c2 = torch.from_numpy(cls2).requires_grad_()
    r2 = torch.from_numpy(reg2).requires_grad_()
    det.head_outputs = lambda net, f: (c2.view(2, s, 2, 2),
                                       r2.view(2, s, 2, 4))
    det.roi_feats = lambda f, rr: None
    got = det.rcnn_losses(None, None, samples, tb['gt'])
    np.testing.assert_allclose(got['loss_emd'].item(),
                               float(want['loss_emd']), rtol=1e-6)
    got['loss_emd'].backward()
    for t, w in ((c2, grads[0]), (r2, grads[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
    # RoIs with one and with two gts at IoU >= 0.5 among the samples
    iou = bbox_overlaps(samples.rois, tb['gt'].bboxes).masked_fill(
        ~tb['gt'].mask[:, None, :], -1.0)
    on = (iou.topk(2, -1).values >= 0.5) & samples.valid[..., None]
    assert int(on[..., 0].sum()) > int(on[..., 1].sum()) > 0


# -------------------------------------------------- the whole slices
@pytest.fixture(scope='module')
def runs():
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = jax_train_run(kind)
        return cache[kind]
    return get


@pytest.mark.parametrize('kind', KINDS)
def test_loss_from_feats_matches_jax(runs, kind, monkeypatch):
    check_loss_from_feats(kind, runs(kind), monkeypatch)


@pytest.mark.parametrize('kind', KINDS)
def test_whole_network_loss_and_grads_match_jax(runs, kind, monkeypatch):
    check_whole_network(kind, runs(kind), monkeypatch)


@pytest.mark.parametrize('kind', KINDS)
def test_fit_two_steps_from_the_config(kind):
    losses = check_fit(kind)
    want = {'loss_rpn_cls', 'loss_rpn_bbox'} | (
        {'loss_emd'} if kind == 'crowddet' else {'loss_cls', 'loss_bbox'})
    assert set(losses[0]) == want
