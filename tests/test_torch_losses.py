"""Port parity: erd_tpu_torch's training losses, box encodings, selection
helpers, anchor valid flags and LR schedule vs erd_tpu, float32 on the CPU.

Inputs come from numpy seeds and go to both packages. Tolerances: loss
values rtol 1e-5 (float32, the same formula op for op); gradients against
``jax.grad`` rtol 1e-4 and atol 1e-6 * max|g| (autodiff on both sides,
summed in another order); masks and index lists exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.engine.schedules import auto_scale_lr as j_auto_scale_lr
from erd_tpu.engine.schedules import warmup_multistep as j_warmup_multistep
from erd_tpu.losses.iou_loss import giou_loss as j_giou_loss
import erd_tpu.losses.gfocal as j_gfocal
import erd_tpu.losses.kd_loss as j_kd
import erd_tpu.losses.utils as j_utils
from erd_tpu.ops.misc import masked_mean_std as j_masked_mean_std
from erd_tpu.ops.misc import topk_mask_select as j_topk_mask_select
from erd_tpu.structures.boxes import bbox2distance as j_bbox2distance
from erd_tpu.structures.boxes import bbox_overlaps as j_bbox_overlaps
from erd_tpu.task.anchors import valid_flags_jax
from erd_tpu_torch.engine import auto_scale_lr, warmup_multistep
from erd_tpu_torch.losses import (binary_cross_entropy_with_logits,
                                  cross_entropy_int, distribution_focal_loss,
                                  giou_loss,
                                  knowledge_distillation_kl_div_loss,
                                  l2_response_loss, quality_focal_loss,
                                  weight_reduce_loss)
from erd_tpu_torch.ops import masked_mean_std, topk_mask_select
from erd_tpu_torch.structures import bbox2distance, bbox_overlaps
from erd_tpu_torch.task import featmap_sizes_for, valid_flags

torch.set_num_threads(2)

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4


def boxes(rs, n, lo=0.0, hi=60.0):
    xy = rs.uniform(lo, hi, (n, 2))
    wh = rs.uniform(1.0, 30.0, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def check_value_and_grad(j_fn, t_fn, *inputs, grad_arg=0):
    """Value (rtol 1e-5) and gradient in input ``grad_arg`` (rtol 1e-4,
    atol 1e-6 * max|g|) of a scalar loss in both packages."""
    j_val, j_grad = jax.value_and_grad(j_fn, argnums=grad_arg)(
        *[jnp.asarray(x) for x in inputs])
    t_in = [torch.from_numpy(np.array(x)) for x in inputs]
    t_in[grad_arg].requires_grad_(True)
    t_val = t_fn(*t_in)
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=VALUE_RTOL)
    want = np.asarray(j_grad)
    np.testing.assert_allclose(t_in[grad_arg].grad.numpy(), want,
                               rtol=GRAD_RTOL,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize('reduction,avg', [('mean', None), ('sum', None),
                                           ('mean', 7.5), ('none', 3.0)])
def test_weight_reduce_loss_matches_jax(reduction, avg):
    rs = np.random.RandomState(0)
    loss = rs.rand(6, 5).astype(np.float32)
    weight = rs.rand(6, 5).astype(np.float32)
    want = j_utils.weight_reduce_loss(jnp.asarray(loss), jnp.asarray(weight),
                                      reduction, avg)
    got = weight_reduce_loss(torch.from_numpy(loss),
                             torch.from_numpy(weight), reduction, avg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=VALUE_RTOL)
    with pytest.raises(ValueError):
        weight_reduce_loss(torch.from_numpy(loss), None, 'sum', 2.0)


def test_bce_and_ce_match_jax():
    rs = np.random.RandomState(1)
    x = (rs.randn(40, 7) * 6).astype(np.float32)
    t = rs.rand(40, 7).astype(np.float32)
    labels = rs.randint(0, 7, 40)
    np.testing.assert_allclose(
        binary_cross_entropy_with_logits(torch.from_numpy(x),
                                         torch.from_numpy(t)).numpy(),
        np.asarray(j_utils.binary_cross_entropy_with_logits(
            jnp.asarray(x), jnp.asarray(t))), rtol=VALUE_RTOL, atol=1e-6)
    np.testing.assert_allclose(
        cross_entropy_int(torch.from_numpy(x),
                          torch.from_numpy(labels)).numpy(),
        np.asarray(j_utils.cross_entropy_int(jnp.asarray(x),
                                             jnp.asarray(labels))),
        rtol=VALUE_RTOL, atol=1e-6)


@pytest.mark.parametrize('beta', [2.0, 1.5])
def test_quality_focal_loss_matches_jax(beta):
    rs = np.random.RandomState(2)
    n, c = 50, 6
    pred = (rs.randn(n, c) * 3).astype(np.float32)
    labels = rs.randint(0, c + 1, n)  # c = background
    score = np.where(labels < c, rs.rand(n), 0).astype(np.float32)
    weight = rs.rand(n).astype(np.float32)
    check_value_and_grad(
        lambda p: j_gfocal.quality_focal_loss(
            p, (jnp.asarray(labels), jnp.asarray(score)),
            jnp.asarray(weight), beta=beta, avg_factor=11.0),
        lambda p: quality_focal_loss(
            p, (torch.from_numpy(labels), torch.from_numpy(score)),
            torch.from_numpy(weight), beta=beta, avg_factor=11.0),
        pred)


def test_distribution_focal_loss_matches_jax():
    rs = np.random.RandomState(3)
    pred = (rs.randn(64, 17) * 2).astype(np.float32)
    label = rs.uniform(0, 15.9, 64).astype(np.float32)
    label[:4] = [0.0, 3.0, 15.9, 7.5]  # integer and edge targets
    weight = rs.rand(64).astype(np.float32)
    check_value_and_grad(
        lambda p: j_gfocal.distribution_focal_loss(
            p, jnp.asarray(label), jnp.asarray(weight), avg_factor=4.0),
        lambda p: distribution_focal_loss(
            p, torch.from_numpy(label), torch.from_numpy(weight),
            avg_factor=4.0),
        pred)


def test_giou_loss_matches_jax():
    rs = np.random.RandomState(4)
    pred = boxes(rs, 80)
    target = boxes(rs, 80)
    pred[:5] = target[:5]  # exact overlap
    weight = rs.rand(80, 4).astype(np.float32)  # collapses to its mean
    check_value_and_grad(
        lambda p: j_giou_loss(p, jnp.asarray(target), jnp.asarray(weight)),
        lambda p: giou_loss(p, torch.from_numpy(target),
                            torch.from_numpy(weight)),
        pred)


@pytest.mark.parametrize('saturate', [False, True])
def test_kd_kl_loss_matches_jax(saturate):
    """Mean over bins, x T^2, teacher detached, 0 * log 0 = 0 (a saturated
    teacher softmax has exact zeros)."""
    rs = np.random.RandomState(5)
    pred = (rs.randn(30, 17) * 3).astype(np.float32)
    soft = (rs.randn(30, 17) * 3).astype(np.float32)
    if saturate:
        soft[:, 0] += 3000.0
    weight = rs.rand(30).astype(np.float32)
    check_value_and_grad(
        lambda p: j_kd.knowledge_distillation_kl_div_loss(
            p, jnp.asarray(soft), jnp.asarray(weight), T=10,
            avg_factor=4.0),
        lambda p: knowledge_distillation_kl_div_loss(
            p, torch.from_numpy(soft), torch.from_numpy(weight), T=10,
            avg_factor=4.0),
        pred)


def test_l2_response_loss_matches_jax():
    rs = np.random.RandomState(6)
    pred = rs.randn(40, 5).astype(np.float32)
    target = rs.randn(40, 5).astype(np.float32)
    mask = rs.rand(40) > 0.7
    check_value_and_grad(
        lambda p: j_kd.l2_response_loss(p, jnp.asarray(target),
                                        mask=jnp.asarray(mask)[:, None]),
        lambda p: l2_response_loss(p, torch.from_numpy(target),
                                   mask=torch.from_numpy(mask)[:, None]),
        pred)
    empty = np.zeros(40, bool)
    got = l2_response_loss(torch.from_numpy(pred), torch.from_numpy(target),
                           mask=torch.from_numpy(empty)[:, None])
    assert got.item() == 0.0


def test_bbox2distance_and_giou_overlaps_match_jax():
    rs = np.random.RandomState(7)
    pts = rs.uniform(0, 60, (50, 2)).astype(np.float32)
    b1 = boxes(rs, 50)
    b2 = boxes(rs, 50)
    np.testing.assert_allclose(
        bbox2distance(torch.from_numpy(pts), torch.from_numpy(b1),
                      max_dis=16).numpy(),
        np.asarray(j_bbox2distance(jnp.asarray(pts), jnp.asarray(b1),
                                   max_dis=16)), rtol=VALUE_RTOL)
    for aligned in (True, False):
        np.testing.assert_allclose(
            bbox_overlaps(torch.from_numpy(b1), torch.from_numpy(b2),
                          mode='giou', is_aligned=aligned).numpy(),
            np.asarray(j_bbox_overlaps(jnp.asarray(b1), jnp.asarray(b2),
                                       mode='giou', is_aligned=aligned)),
            rtol=VALUE_RTOL, atol=1e-6)


def test_masked_mean_std_matches_jax():
    rs = np.random.RandomState(8)
    x = rs.randn(3, 200).astype(np.float32)
    mask = rs.rand(3, 200) > 0.3
    for b in range(3):
        jm, js = j_masked_mean_std(jnp.asarray(x[b]), jnp.asarray(mask[b]))
        m, s = masked_mean_std(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_allclose(m[b].item(), float(jm), rtol=VALUE_RTOL)
        np.testing.assert_allclose(s[b].item(), float(js), rtol=VALUE_RTOL)


def test_topk_mask_select_ties_match_jax():
    """bf16-valued criteria: many exact ties, ordered lowest index first as
    lax.top_k orders them."""
    rs = np.random.RandomState(9)
    x = np.round(rs.randn(2, 500) * 4) / 4
    x = x.astype(np.float32)
    for b in range(2):
        ji, jm = j_topk_mask_select(jnp.asarray(x[b]), 120, 0.5)
        ti, tm = topk_mask_select(torch.from_numpy(x), 120, 0.5)
        np.testing.assert_array_equal(ti[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tm[b].numpy(), np.asarray(jm))


def test_valid_flags_match_jax():
    sizes = featmap_sizes_for((96, 160), (8, 16, 32, 64, 128))
    pads = np.asarray([[96.0, 160.0], [64.0, 96.0], [32.0, 128.0]],
                      np.float32)
    got = valid_flags(sizes, (8, 16, 32, 64, 128), torch.from_numpy(pads))
    for b, pad in enumerate(pads):
        want = valid_flags_jax(sizes, (8, 16, 32, 64, 128), jnp.asarray(pad))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert not got[2].all() and got[0].all()


def test_warmup_multistep_matches_jax():
    want = j_warmup_multistep(0.01, warmup_iters=500, warmup_factor=0.001,
                              milestones_steps=(1000, 2000), gamma=0.1)
    got = warmup_multistep(0.01, warmup_iters=500, warmup_factor=0.001,
                           milestones_steps=(1000, 2000), gamma=0.1)
    for step in (0, 1, 250, 499, 500, 999, 1000, 1500, 2000, 2500):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert auto_scale_lr(0.01, 8) == pytest.approx(j_auto_scale_lr(0.01, 8))
