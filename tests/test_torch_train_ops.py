"""Port parity of the training slice's kernel modules, through their plain
versions on the CPU: ATSS, GFL targets and the fused GFL loss, ERS
selection, and the ERD distillation, vs erd_tpu (and its test oracles).

Tolerances: ATSS pos_mask / gt_idx / labels exactly; ERS masks, index
lists and counts exactly (bf16-quantised inputs, so criteria tie often);
loss values rtol 1e-5 and gradients rtol 1e-4 with atol 1e-6 * max|g|
(float32, summed in another order); per-image ERD distillation terms rtol
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.models.detectors.gfl_erd import ERDConfig as JERDConfig
from erd_tpu.models.detectors.gfl_erd import \
    ers_cls_mask_dense as j_ers_cls_mask_dense
from erd_tpu.models.detectors.gfl_erd import \
    erd_distill_losses as j_erd_distill_losses
from erd_tpu.models.heads.gfl_head import AnchorContext as JAnchorContext
from erd_tpu.models.heads.gfl_head import GFLTrainConfig as JTrainConfig
from erd_tpu.models.heads.gfl_head import gfl_loss as j_gfl_loss
from erd_tpu.models.heads.gfl_head import gfl_targets as j_gfl_targets
from erd_tpu.ops.misc import masked_mean_std as j_masked_mean_std
from erd_tpu.ops.misc import topk_mask_select as j_topk_mask_select
from erd_tpu.structures.det_sample import GTInstances as JGTInstances
from erd_tpu.task.atss import atss_assign_batch as j_atss_assign_batch
from erd_tpu_torch.models.detectors.gfl_erd import (ERDConfig,
                                                    erd_distill_losses)
from erd_tpu_torch.models.heads.gfl_head import (AnchorContext,
                                                 GFLTrainConfig, gfl_loss,
                                                 gfl_targets)
from erd_tpu_torch.models.detectors import gfl_erd as gfl_erd_module
from erd_tpu_torch.ops.erd_distill import (erd_distill_plain,
                                           fused_erd_distill)
from erd_tpu_torch.ops.ers_select import ers_select
from erd_tpu_torch.structures import GTInstances
from erd_tpu_torch.task import (AnchorGenerator, atss_assign,
                                featmap_sizes_for)
from tests.conftest import rand_boxes
from tests.test_atss import np_atss
from tests.test_parity_oracle import (_random_batch, oracle_erd_distill,
                                      oracle_gfl_loss)

torch.set_num_threads(2)


def bf16(x):
    """Round float32 values to bfloat16 (ties to even), kept in float32."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def padded_gt(rs, b, g_max, w, h, num_classes, min_size=10):
    gtb = np.zeros((b, g_max, 4), np.float32)
    gtl = np.zeros((b, g_max), np.int32)
    gtm = np.zeros((b, g_max), bool)
    for i in range(b):
        g = rs.randint(1, g_max)
        gtb[i, :g] = rand_boxes(rs, g, w=w, h=h, min_size=min_size)
        gtl[i, :g] = rs.randint(0, num_classes, g)
        gtm[i, :g] = True
    return gtb, gtl, gtm


def grid(shape):
    gen = AnchorGenerator()
    sizes = featmap_sizes_for(shape, gen.strides)
    return gen.flat_anchors(sizes), gen.num_level_anchors(sizes)


# ---------------------------------------------------------------- ATSS
def test_atss_matches_oracle():
    """erd_tpu's tests/test_atss.py oracle (the reference algorithm with
    dynamic shapes), four images in one batch."""
    rng = np.random.RandomState(0)
    anchors, nla = grid((160, 224))
    b, g_max = 4, 8
    gtb = np.zeros((b, g_max, 4), np.float32)
    gtl = np.zeros((b, g_max), np.int32)
    gtm = np.zeros((b, g_max), bool)
    counts = []
    for i in range(b):
        g = rng.randint(1, 7)
        gtb[i, :g] = rand_boxes(rng, g, w=224, h=160, min_size=10)
        gtl[i, :g] = rng.randint(0, 5, g)
        gtm[i, :g] = True
        counts.append(g)
    res = atss_assign(torch.from_numpy(anchors), nla, torch.from_numpy(gtb),
                      torch.from_numpy(gtl), torch.from_numpy(gtm),
                      torch.ones((b, len(anchors)), dtype=torch.bool))
    for i, g in enumerate(counts):
        want_assign, _ = np_atss(anchors, nla, gtb[i, :g])
        want_pos = want_assign >= 0
        got_pos = res.pos_mask[i].numpy()
        np.testing.assert_array_equal(got_pos, want_pos)
        np.testing.assert_array_equal(res.gt_idx[i].numpy()[got_pos],
                                      want_assign[want_pos])
        np.testing.assert_array_equal(res.labels[i].numpy()[got_pos],
                                      gtl[i][want_assign[want_pos]])
    assert res.pos_mask.any()


def test_atss_no_gt():
    anchors, nla = grid((64, 64))
    g = 4
    res = atss_assign(torch.from_numpy(anchors), nla, torch.zeros(1, g, 4),
                      torch.zeros(1, g, dtype=torch.int32),
                      torch.zeros(1, g, dtype=torch.bool),
                      torch.ones(1, len(anchors), dtype=torch.bool))
    assert not res.pos_mask.any()
    assert (res.labels == -1).all() and (res.max_overlaps == -1e8).all()


def test_atss_valid_flags_exclude():
    """Anchors marked invalid never become positive."""
    rng = np.random.RandomState(1)
    anchors, nla = grid((160, 224))
    gtb = np.zeros((1, 4, 4), np.float32)
    gtb[0, :3] = rand_boxes(rng, 3, w=224, h=160, min_size=20)
    gtm = np.array([[True, True, True, False]])
    res = atss_assign(torch.from_numpy(anchors), nla, torch.from_numpy(gtb),
                      torch.zeros(1, 4, dtype=torch.int32),
                      torch.from_numpy(gtm),
                      torch.zeros(1, len(anchors), dtype=torch.bool))
    assert not res.pos_mask.any()


@pytest.mark.parametrize('shape', [(160, 224), (96, 128)])
def test_atss_matches_jax_exactly(shape):
    """Symmetric anchor grids put many anchor centres at equal distances
    from a gt centre; equal distances must order lowest anchor first, as
    lax.top_k does. Half of the anchors of image 1 are invalid."""
    rs = np.random.RandomState(sum(shape))
    anchors, nla = grid(shape)
    b, g_max = 3, 6
    gtb, gtl, gtm = padded_gt(rs, b, g_max, shape[1], shape[0], 7)
    # gt centred on anchor centres: exact distance ties
    gtb[0, 0] = [16.0, 16.0, 48.0, 48.0]
    gtb[0, 1] = [40.0, 24.0, 88.0, 72.0]
    gtm[0, :2] = True
    vf = np.ones((b, len(anchors)), bool)
    vf[1, ::2] = False
    want = j_atss_assign_batch(jnp.asarray(anchors), nla, jnp.asarray(gtb),
                               jnp.asarray(gtl), jnp.asarray(gtm),
                               jnp.asarray(vf))
    got = atss_assign(torch.from_numpy(anchors), nla, torch.from_numpy(gtb),
                      torch.from_numpy(gtl), torch.from_numpy(gtm),
                      torch.from_numpy(vf))
    np.testing.assert_array_equal(got.pos_mask.numpy(),
                                  np.asarray(want.pos_mask))
    assert got.pos_mask.sum() > 10
    np.testing.assert_array_equal(got.gt_idx.numpy(),
                                  np.asarray(want.gt_idx))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(want.max_overlaps), rtol=1e-6)


def test_atss_plain_matches_jax_on_ties_across_topk_and_cut_levels():
    """The plain version the card holds the ATSS kernel to, pinned to
    erd_tpu where the kernel's order matters most: gt centres on the
    midpoints between P3 anchor centres (equal distances in groups of 2, 4
    and 8, across the 9th slot) and valid flags of a pad shape that cuts
    every level (one image's P3 wholly invalid)."""
    from erd_tpu_torch.task import atss_assign_plain, valid_flags
    shape = (96, 128)
    ctx = AnchorContext.build(shape)
    anchors, nla = ctx.anchors, ctx.num_level_anchors
    ctr = (anchors[:nla[0], :2] + anchors[:nla[0], 2:]) / 2
    xs, ys = np.unique(ctr[:, 0]), np.unique(ctr[:, 1])
    gtb = np.zeros((2, 4, 4), np.float32)
    for j, (i, k, half) in enumerate(((3, 2, 12.0), (6, 4, 20.0),
                                      (9, 7, 9.0), (1, 1, 30.0))):
        cx = (xs[i] + xs[i + 1]) / 2 if j % 2 == 0 else xs[i]
        cy = (ys[k] + ys[k + 1]) / 2
        gtb[:, j] = [cx - half, cy - half, cx + half, cy + half]
    gtl = np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.int32)
    gtm = np.ones((2, 4), bool)
    vf = valid_flags(ctx.featmap_sizes, ctx.strides,
                     torch.tensor([[72.0, 96.0], [96.0, 128.0]])).numpy()
    vf[1, :nla[0]] = False
    d = np.sqrt(((ctr[None, :, None] - ((gtb[..., :2] + gtb[..., 2:]) / 2)[
        :, None]) ** 2).sum(-1))
    d = np.sort(np.where(vf[:, :nla[0], None], d, 1e8), axis=1)
    assert (d[:, 8] == d[:, 9]).any()
    assert 0 < vf[0].sum() < len(anchors)
    want = j_atss_assign_batch(jnp.asarray(anchors), nla, jnp.asarray(gtb),
                               jnp.asarray(gtl), jnp.asarray(gtm),
                               jnp.asarray(vf))
    got = atss_assign_plain(torch.from_numpy(anchors), nla,
                            torch.from_numpy(gtb), torch.from_numpy(gtl),
                            torch.from_numpy(gtm), torch.from_numpy(vf))
    assert got.pos_mask.sum() > 4
    for name in ('pos_mask', 'gt_idx', 'labels'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(want.max_overlaps), rtol=1e-6)


# ------------------------------------------------------- GFL targets/loss
def test_gfl_targets_match_jax():
    shape = (96, 128)
    rs = np.random.RandomState(2)
    jctx, ctx = JAnchorContext.build(shape), AnchorContext.build(shape)
    gtb, gtl, gtm = padded_gt(rs, 2, 8, shape[1], shape[0], 5)
    img_shapes = np.asarray([[90.0, 100.0], [96.0, 128.0]], np.float32)
    want = j_gfl_targets(jctx, JGTInstances(
        bboxes=jnp.asarray(gtb), labels=jnp.asarray(gtl),
        mask=jnp.asarray(gtm)), jnp.asarray(img_shapes), 5)
    got = gfl_targets(ctx, GTInstances(
        bboxes=torch.from_numpy(gtb), labels=torch.from_numpy(gtl),
        mask=torch.from_numpy(gtm)), torch.from_numpy(img_shapes), 5)
    for name in ('labels', 'label_weights', 'bbox_targets', 'pos_mask'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.num_pos.item() == float(want.num_pos) > 0


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_gfl_loss_and_grads_match_jax(seed):
    """erd_tpu's test_parity_oracle GFL-loss batch; the class logits are
    the new-class slice of a wider map, as in the ERD step."""
    shape = (64, 64)
    jctx, ctx = JAnchorContext.build(shape), AnchorContext.build(shape)
    rs = np.random.RandomState(seed)
    b, c, old = 2, 6, 3
    cls, reg, gtb, gtl, gtm = _random_batch(rs, jctx, b, c)
    wide = np.concatenate([rs.randn(b, cls.shape[1], old).astype(np.float32),
                           cls], -1)
    img_shapes = np.asarray([[60.0, 50.0], [64.0, 64.0]], np.float32)
    jt = j_gfl_targets(jctx, JGTInstances(
        bboxes=jnp.asarray(gtb), labels=jnp.asarray(gtl),
        mask=jnp.asarray(gtm)), jnp.asarray(img_shapes), c)

    def j_total(cl, rg):
        losses = j_gfl_loss(jctx, cl[..., old:], rg, jt, JTrainConfig())
        return sum(losses.values()), losses

    (_, j_losses), (j_gc, j_gr) = jax.value_and_grad(
        j_total, argnums=(0, 1), has_aux=True)(jnp.asarray(wide),
                                               jnp.asarray(reg))
    targets = gfl_targets(ctx, GTInstances(
        bboxes=torch.from_numpy(gtb), labels=torch.from_numpy(gtl),
        mask=torch.from_numpy(gtm)), torch.from_numpy(img_shapes), c)
    cl = torch.from_numpy(wide).requires_grad_(True)
    rg = torch.from_numpy(reg).requires_grad_(True)
    losses = gfl_loss(ctx, cl[..., old:], rg, targets, GFLTrainConfig())
    sum(losses.values()).backward()
    assert set(losses) == set(j_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(j_losses[k]), rtol=1e-5,
                                   err_msg=k)
    for got, want in ((cl.grad, j_gc), (rg.grad, j_gr)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
    assert cl.grad[..., :old].abs().max() == 0
    # and erd_tpu's torch oracle of the reference loss (rtol 1e-4, as there)
    want = oracle_gfl_loss(jctx, cls, reg, targets.labels.numpy(),
                           targets.label_weights.numpy(),
                           targets.bbox_targets.numpy(),
                           targets.num_pos.item(), c)
    for k, w in zip(('loss_cls', 'loss_bbox', 'loss_dfl'), want):
        np.testing.assert_allclose(losses[k].item(), w, rtol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------------------ ERS
@pytest.mark.parametrize('seed', [0, 1, 'ties', 'signed_zeros'])
def test_ers_select_matches_jax_exactly(seed):
    """bf16-valued teacher outputs, so criteria tie often. The lists are
    held exactly; a mask entry may differ only where its criterion lies
    within 1e-6 * |thr| of the threshold (the mean and std are summed in
    another order), and none does here. ``ties``: every criterion equal,
    so the list is rows 0 ... cap - 1 and nothing is masked (the order the
    card's kernel is held to); ``signed_zeros``: -0 and +0 among the reg
    maxima, which lax.top_k ranks +0 first."""
    rs = np.random.RandomState(seed if isinstance(seed, int) else 2)
    b, n, c = 2, 700, 5
    t_cls = rs.randn(b, n, c) * 2 - 4
    t_reg = rs.randn(b, n, 68) * 1.5
    hot = rs.choice(n, 40, replace=False)
    t_cls[:, hot, 0] += 6.0
    t_reg[:, hot] += 3.0
    if seed == 'ties':
        t_cls = np.full_like(t_cls, -2.0)
        t_reg = np.full_like(t_reg, 1.5)
    if seed == 'signed_zeros':
        # every bin <= -1 but one in each row that is not hot: -0 in most
        # rows, +0 in a few, so the cap-th slot falls among the -0s
        cold = np.setdiff1d(np.arange(n), hot)
        t_reg[:, cold] = -np.abs(t_reg[:, cold]) - 1
        zero = np.where(rs.rand(b, cold.size) < 0.9, -0.0, 0.0)
        t_reg[:, cold, 7] = zero
    t_cls, t_reg = bf16(t_cls), bf16(t_reg)
    cap = n // 5 + 1
    cls_mask, reg_idx, reg_mask, count = ers_select(
        torch.from_numpy(t_cls), torch.from_numpy(t_reg), cap)
    for i in range(b):
        want_cls = np.asarray(j_ers_cls_mask_dense(jnp.asarray(t_cls[i])))
        crit = jnp.asarray(t_reg[i]).max(-1)
        mean, std = j_masked_mean_std(crit, jnp.ones((n,), bool))
        ji, jm = j_topk_mask_select(crit, cap, mean + 2 * std)
        np.testing.assert_array_equal(cls_mask[i].numpy(), want_cls)
        np.testing.assert_array_equal(reg_idx[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(reg_mask[i].numpy(), np.asarray(jm))
        assert count[i].item() == int(np.asarray(jm).sum())
        vals = np.asarray(crit)[np.asarray(ji)]
        if seed == 'ties':
            np.testing.assert_array_equal(reg_idx[i].numpy(), np.arange(cap))
            assert count[i].item() == 0 and want_cls.sum() == 0
            continue
        assert count[i].item() > 0
        assert 0 < want_cls.sum() < n
        # ties were present in the selected prefix and beyond it
        assert (np.diff(vals) == 0).any()
        if seed == 'signed_zeros':
            signs = np.signbit(vals[vals == 0])
            assert signs.any() and not signs.all()
            assert not (np.diff(signs.astype(int)) < 0).any()  # +0 first


# ---------------------------------------------------------- distillation
def distill_inputs(rs, n, ori_c=3, total_c=6, many=False):
    s_cls = rs.randn(2, n, total_c).astype(np.float32)
    s_reg = (rs.randn(2, n, 68) * 2).astype(np.float32)
    t_cls = (rs.randn(2, n, ori_c) - 3.0).astype(np.float32)
    if many:  # ~18% of the rows above mu + 2 sigma
        t_reg = (rs.randn(2, n, 68) * 0.05).astype(np.float32)
        t_reg[:, rs.choice(n, n * 18 // 100, replace=False)] += 10.0
    else:
        t_reg = (rs.randn(2, n, 68) * 2).astype(np.float32)
    hot = rs.choice(n, 8, replace=False)
    t_cls[:, hot, 0] += 8.0
    return s_cls, s_reg, t_cls, t_reg


@pytest.mark.parametrize('many', [False, True])
def test_erd_distill_losses_match_jax_on_both_branches(many):
    """erd_tpu's test_erd fast-path test: with few selections the NMS runs
    over the first K candidates, with many over all of them; both give
    erd_tpu's values, and the fast path equals the path without it."""
    rs = np.random.RandomState(3 + many)
    n = 600
    anchors = np.stack([rs.uniform(0, 50, n), rs.uniform(0, 50, n),
                        rs.uniform(50, 100, n), rs.uniform(50, 100, n)],
                       -1).astype(np.float32)
    inputs = distill_inputs(rs, n, many=many)
    fast_k = 32
    got = {}
    for k in (fast_k, 0):
        cfg = ERDConfig(ori_num_classes=3, ers_nms_fast_k=k)
        got[k] = erd_distill_losses(torch.from_numpy(anchors),
                                    *map(torch.from_numpy, inputs), cfg)
        branch = erd_distill_losses.last_branch
        if k == 0:
            assert branch == dict(selected=None, nms_k=n // 5 + 1)
        else:
            assert (branch['selected'] > fast_k) == many
            assert branch['nms_k'] == (n // 5 + 1 if many else fast_k)
        want = j_erd_distill_losses(
            jnp.asarray(anchors), *map(jnp.asarray, inputs),
            JERDConfig(ori_num_classes=3, ers_nms_fast_k=k))
        for g, w in zip(got[k], want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)
            assert (g > 0).all()
    for a, b in zip(got[fast_k], got[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize('seed', [0, 7])
def test_erd_distill_matches_oracle(seed):
    """erd_tpu's test_parity_oracle ERD-distill oracle (the reference's
    sel_pos + distill_loss_by_image_single with dynamic shapes)."""
    ctx = JAnchorContext.build((64, 64))
    rs = np.random.RandomState(seed)
    n = ctx.num_anchors
    b, ori_c, total_c = 2, 5, 8
    t_cls = (rs.randn(b, n, ori_c) - 5.0).astype(np.float32)
    t_reg = (rs.randn(b, n, 68) * 2).astype(np.float32)
    s_cls = rs.randn(b, n, total_c).astype(np.float32)
    s_reg = (rs.randn(b, n, 68) * 2).astype(np.float32)
    for i in range(b):
        hot = rs.choice(n, 6, replace=False)
        t_cls[i, hot, rs.randint(0, ori_c, 6)] += 8.0
        t_reg[i, hot] += 6.0
    l_cls, l_reg = erd_distill_losses(
        torch.from_numpy(ctx.anchors), torch.from_numpy(s_cls),
        torch.from_numpy(s_reg), torch.from_numpy(t_cls),
        torch.from_numpy(t_reg), ERDConfig(ori_num_classes=ori_c))
    for i in range(b):
        o_cls, o_reg = oracle_erd_distill(ctx.anchors, s_cls[i], s_reg[i],
                                          t_cls[i], t_reg[i], ori_c)
        np.testing.assert_allclose(l_cls[i].item(), o_cls, rtol=1e-4)
        np.testing.assert_allclose(l_reg[i].item(), o_reg, rtol=1e-4)


@pytest.mark.parametrize('via', ['losses', 'wrapper'])
def test_erd_distill_grads_match_jax(via, monkeypatch):
    """Gradients of the distillation terms into the student logits (the
    teacher is detached); the masks come from the same selection. ``via``
    ``wrapper``: the CPU ``fused_erd_distill`` called on the masks that
    ``erd_distill_losses`` hands it, its gradient of the whole 6-wide
    ``s_cls`` (zeros past the teacher's 3 columns) against ``jax.grad``."""
    rs = np.random.RandomState(5)
    n = 300
    anchors = np.stack([rs.uniform(0, 50, n), rs.uniform(0, 50, n),
                        rs.uniform(50, 100, n), rs.uniform(50, 100, n)],
                       -1).astype(np.float32)
    s_cls, s_reg, t_cls, t_reg = distill_inputs(rs, n)
    cfg = JERDConfig(ori_num_classes=3)

    def j_total(sc, sr):
        l_cls, l_reg = j_erd_distill_losses(
            jnp.asarray(anchors), sc, sr, jnp.asarray(t_cls),
            jnp.asarray(t_reg), cfg)
        return l_cls.sum() + l_reg.sum()

    j_gc, j_gr = jax.grad(j_total, argnums=(0, 1))(jnp.asarray(s_cls),
                                                   jnp.asarray(s_reg))
    sc = torch.from_numpy(s_cls).requires_grad_(True)
    sr = torch.from_numpy(s_reg).requires_grad_(True)
    seen = []
    wrapper = gfl_erd_module.fused_erd_distill
    monkeypatch.setattr(gfl_erd_module, 'fused_erd_distill',
                        lambda *a, **kw: seen.append((a, kw)) or
                        wrapper(*a, **kw))
    l_cls, l_reg = erd_distill_losses(
        torch.from_numpy(anchors), sc, sr, torch.from_numpy(t_cls),
        torch.from_numpy(t_reg), ERDConfig(ori_num_classes=3))
    if via == 'wrapper':
        (args, kw), = seen
        sc = torch.from_numpy(s_cls).requires_grad_(True)
        sr = torch.from_numpy(s_reg).requires_grad_(True)
        l_cls, l_reg = fused_erd_distill(sc, sr, *args[2:], **kw)
    (l_cls.sum() + l_reg.sum()).backward()
    for got, want in ((sc.grad, j_gc), (sr.grad, j_gr)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
    assert sc.grad.shape == (2, n, 6)
    assert sc.grad[..., 3:].abs().max() == 0


def test_erd_distill_plain_is_zero_for_equal_logits():
    rs = np.random.RandomState(6)
    n = 50
    t_cls = rs.randn(2, n, 3).astype(np.float32)
    t_reg = rs.randn(2, n, 68).astype(np.float32)
    s_cls = np.concatenate([t_cls, rs.randn(2, n, 2).astype(np.float32)], -1)
    masks = [torch.from_numpy(rs.rand(2, n) > 0.5) for _ in range(2)]
    l_cls, l_reg = erd_distill_plain(
        torch.from_numpy(s_cls), torch.from_numpy(t_reg.copy()),
        torch.from_numpy(t_cls), torch.from_numpy(t_reg), *masks)
    assert l_cls.abs().max() == 0
    assert l_reg.abs().max() < 1e-6
