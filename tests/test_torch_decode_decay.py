"""Port parity for the GFL integral decode read from the head's level maps
(``integral_decode``, kernel csrc/integral_decode.cu) and SOLOv2's matrix
decay fused with its mask IoU (``mask_matrix_decay``, kernel
``erd_mask_matrix_decay`` in csrc/extra_nms.cu): their plain versions
against erd_tpu, float32 on the CPU, the identities the kernels rest on,
and the wrappers' routing.

Tolerances, each with its reason:
- decoded boxes against erd_tpu: 1e-4 * stride + 1e-5 * |box| px, the
  kernel's gate against plain (XLA's softmax and einsum round the 17 bins
  in another order than torch's, an ulp or two of the expectation);
- the level maps against their flat float32 copy, the fused decay against
  the decay on the IoU, the sparse identity: bit-equal (the same float32
  values through the same ops);
- decayed scores against erd_tpu: rtol 1e-6 with zeros equal (an exp of the
  same float32 terms may differ from XLA's by an ulp).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.ops.integral import integral as j_integral
from erd_tpu.structures.boxes import distance2bbox as j_distance2bbox
from erd_tpu_torch.models.heads import gfl_head
from erd_tpu_torch.models.heads.gfl_head import (AnchorContext,
                                                 GFLTestConfig, gfl_predict)
from erd_tpu_torch.ops import (integral_decode, mask_matrix_decay,
                               mask_matrix_decay_plain, matrix_decay_plain)
from erd_tpu_torch.ops.extra_nms import mask_matrix_decay_capacity
from erd_tpu_torch.ops.integral import flat_logits, level_plan
from erd_tpu_torch.structures import ImageMeta, stack_to

torch.set_num_threads(2)

LEVELS = ((8, 12), (4, 6), (2, 3))
STRIDES = (8, 16, 32)


def level_maps(seed, dtype, layout, b=2):
    """Head-like (B, H, W, 68) logits of LEVELS: NHWC views of NCHW maps
    (the head's layout, channel stride H * W) or contiguous NHWC, float32
    or bf16; (maps, per-anchor centres (N, 2), strides (N,))."""
    rs = np.random.RandomState(seed)
    maps, centers, strides = [], [], []
    for (h, w), s in zip(LEVELS, STRIDES):
        x = torch.from_numpy((rs.randn(b, 68, h, w) * 3).astype(np.float32))
        x = x.to(dtype)
        m = x.permute(0, 2, 3, 1)
        maps.append(m.contiguous() if layout == 'nhwc' else m)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        centers.append(np.stack([xs, ys], -1).reshape(-1, 2) * s + s / 2)
        strides.append(np.full(h * w, s, np.float32))
    return (maps, torch.from_numpy(np.concatenate(centers).astype(
        np.float32)), torch.from_numpy(np.concatenate(strides)))


def candidate_rows(seed, b, n, k):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(np.stack([rs.randint(0, n, k)
                                      for _ in range(b)]).astype(np.int64))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', ['nchw_view', 'nhwc'])
def test_level_decode_plain_matches_erd_tpu(dtype, layout):
    """The decode of candidate rows read from the level maps (any strides,
    bf16 widened exactly) against erd_tpu's integral x stride +
    distance2bbox clipped to each image's (H, W)."""
    maps, centers, strides = level_maps(1, dtype, layout)
    n = centers.shape[0]
    rows = candidate_rows(2, 2, n, 40)
    img_shape = torch.tensor([[70.0, 90.0], [64.0, 80.0]])
    got = integral_decode(maps, rows, centers, strides, img_shape)
    flat = np.concatenate([m.float().reshape(2, -1, 68).numpy()
                           for m in maps], 1)
    for i in range(2):
        r = rows[i].numpy()
        dist = j_integral(jnp.asarray(flat[i][r])) * \
            strides.numpy()[r][:, None]
        want = np.asarray(j_distance2bbox(
            jnp.asarray(centers.numpy()[r]), dist,
            max_shape=tuple(img_shape[i].tolist())))
        tol = 1e-4 * strides.numpy()[r][:, None] + 1e-5 * np.abs(want)
        assert (np.abs(got[i].numpy() - want) <= tol).all()
    assert bool((got[..., 0::2] <= 90.0).all()) and bool((got >= 0).all())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_level_decode_equals_flat_float32_form(dtype):
    """The level maps and their flat float32 copy (what the parent's path
    built with a cat) decode to the same bits."""
    maps, centers, strides = level_maps(3, dtype, 'nchw_view')
    flat = flat_logits(maps)
    assert flat.dtype == torch.float32 and flat.shape == (2, 126, 68)
    rows = candidate_rows(4, 2, 126, 60)
    shape = torch.tensor([[60.0, 100.0], [50.0, 70.0]])
    assert torch.equal(integral_decode(maps, rows, centers, strides, shape),
                       integral_decode(flat, rows, centers, strides, shape))
    assert torch.equal(integral_decode(maps, rows, centers, strides, None),
                       integral_decode(flat, rows, centers, strides, None))


def test_level_plan_describes_the_maps_as_the_kernel_reads_them():
    """The kernel's view of a call: each map's element strides (batch, row,
    column, channel), first row and width; vector loads only where every
    map's channels are unit-stride with rows on 4-element boundaries; a
    flat (B, N, 68) map is one level of height 1."""
    maps, _, _ = level_maps(5, torch.float32, 'nchw_view')
    plan = level_plan(maps)
    assert (plan.count, plan.rows, plan.bf16) == (3, 126, 0)
    assert list(plan.starts) == [0, 96, 120] and list(plan.widths) == [
        12, 6, 3]
    assert list(plan.strides)[:4] == [68 * 96, 12, 1, 96]
    assert not plan.vec_strides
    nhwc, _, _ = level_maps(5, torch.bfloat16, 'nhwc')
    plan = level_plan(nhwc)
    assert plan.vec_strides and plan.bf16 == 1 and plan.align == 8
    flat = flat_logits(maps)
    plan = level_plan([flat.unsqueeze(1)])
    assert plan.vec_strides and plan.rows == 126 and plan.align == 16
    odd = torch.zeros(2, 126, 69)[..., :68]
    assert not level_plan([odd.unsqueeze(1)]).vec_strides


def test_decode_wrapper_refuses_what_the_kernel_does_not_take():
    maps, centers, strides = level_maps(6, torch.float32, 'nhwc')
    rows = candidate_rows(7, 2, 126, 8)
    with pytest.raises(ValueError, match='channels'):
        integral_decode([m[..., :60] for m in maps], rows, centers, strides,
                        None)
    with pytest.raises(ValueError, match='centers'):
        integral_decode(maps, rows, centers[:-1], strides, None)
    with pytest.raises(ValueError, match='level maps'):
        integral_decode([m[0] for m in maps], rows, centers, strides, None)
    with pytest.raises(ValueError, match='rows'):
        integral_decode(maps, rows[0], centers, strides, None)


def test_gfl_predict_hands_the_level_maps_to_the_decode(monkeypatch):
    """GFL serving decodes from the head's distribution maps as they lie:
    the decode gets the very tensors (no cast, no concatenation), and the
    detections equal those from contiguous float32 copies."""
    ctx = AnchorContext.build((64, 96))
    rs = np.random.RandomState(8)
    cls, reg = [], []
    for h, w in ctx.featmap_sizes:
        cls.append(torch.from_numpy(rs.randn(1, 5, h, w).astype(
            np.float32)).permute(0, 2, 3, 1))
        reg.append(torch.from_numpy((rs.randn(1, 68, h, w) * 2).astype(
            np.float32)).permute(0, 2, 3, 1))
    meta = stack_to([ImageMeta.make((60, 90), (60, 90), (1.0, 1.0))],
                    'cpu')
    seen = []

    def spy(*args):
        seen.append(args[0])
        return integral_decode(*args)
    monkeypatch.setattr(gfl_head, 'integral_decode', spy)
    cfg = GFLTestConfig(score_thr=0.0)
    got = gfl_predict(ctx, cls, reg, meta, cfg)
    assert len(seen) == 1 and all(a is b for a, b in zip(seen[0], reg))
    want = gfl_predict(ctx, cls, [r.contiguous() for r in reg], meta, cfg)
    assert int(got.mask.sum()) > 0
    for f in ('bboxes', 'scores', 'labels', 'mask'):
        assert torch.equal(getattr(got, f), getattr(want, f))


# ------------------------------------------------ the mask-IoU decay
def mask_case(seed, n, case, num_labels=3, hw=12):
    """Binary masks' overlaps and areas as SOLOv2 makes them, scores with
    zero slots, ties or one class: (scores, inter, area, labels)."""
    rs = np.random.RandomState(seed)
    base = rs.rand(4, hw * hw) < 0.4
    pick = rs.randint(0, 4, n)
    masks = (base[pick] ^ (rs.rand(n, hw * hw) < 0.1)).astype(np.float32)
    masks[rs.rand(n) < 0.1] = 0.0  # empty masks: union clamped to 1
    scores = (rs.randint(0, 8, n) / 8).astype(np.float32)
    labels = rs.randint(0, num_labels, n)
    if case == 'tied_top':
        scores[:3] = scores.max() + 0.25
    elif case == 'all_zero':
        scores[:] = 0.0
    elif case == 'one_class':
        labels[:] = 0
    elif case == 'live_prefix':  # SOLOv2's: top-k scores, the rest zero
        scores = np.sort(rs.rand(n).astype(np.float32))[::-1].copy()
        scores[n // 2:] = 0.0
    inter = masks @ masks.T
    return (torch.from_numpy(scores), torch.from_numpy(inter),
            torch.from_numpy(masks.sum(-1)), torch.from_numpy(labels))


def jax_mask_decay(scores, inter, area, labels, sigma=2.0):
    """erd_tpu/models/detectors/solov2.py:400-410, the mask IoU and the
    gaussian decay as erd_tpu writes them inline (one image)."""
    score, inter, area = (jnp.asarray(t.numpy()) for t in (scores, inter,
                                                           area))
    lab = jnp.asarray(labels.numpy())
    union = area[:, None] + area[None, :] - inter
    miou = inter / jnp.maximum(union, 1.0)
    same = lab[:, None] == lab[None, :]
    higher = score[None, :] > score[:, None]
    decay_iou = jnp.where(same & higher, miou, 0.0)
    comp = decay_iou.max(axis=1)
    decay = jnp.exp(-sigma * (decay_iou ** 2 - comp[None, :] ** 2))
    return np.asarray(score * decay.min(axis=1))


CASES = ['random', 'tied_top', 'all_zero', 'one_class', 'live_prefix']


@pytest.mark.parametrize('case', CASES)
def test_mask_decay_plain_matches_erd_tpu(case):
    scores, inter, area, labels = mask_case(11, 60, case)
    got = mask_matrix_decay_plain(scores, inter, area, labels).numpy()
    want = jax_mask_decay(scores, inter, area, labels)
    live = want != 0
    assert ((got == 0) == (want == 0)).all()
    assert (np.abs(got - want)[live] <= 1e-6 * np.abs(want)[live]).all()
    assert case == 'all_zero' or (want < scores.numpy()).any()


def sparse_decay(scores, iou, labels, sigma=2.0, kernel='gaussian'):
    """The kernel's shortcut, written out: a zero score stays as it is;
    another row takes min(1, f over the j of its class with a strictly
    higher score), f(d, comp_j) as ``matrix_decay_plain`` rounds it."""
    same = labels[:, None] == labels[None, :]
    higher = scores[None, :] > scores[:, None]
    on = same & higher
    decay_iou = torch.where(on, iou, torch.zeros_like(iou))
    comp = decay_iou.amax(-1)[None, :]
    if kernel == 'gaussian':
        f = torch.exp(-sigma * (decay_iou ** 2 - comp ** 2))
    else:
        f = (1 - decay_iou) / (1 - comp).clamp(min=1e-6)
    low = torch.where(on, f, torch.ones_like(f)).amin(-1).clamp(max=1.0)
    return torch.where(scores == 0, scores, scores * low)


@pytest.mark.parametrize('kernel', ['gaussian', 'linear'])
@pytest.mark.parametrize('case', CASES)
def test_sparse_shortcut_equals_the_full_decay(case, kernel):
    """min over every j equals min(1, min over the terms whose condition
    holds), and a zero score's output is that zero: the work the kernel
    skips cannot change a bit (scores >= 0, mask IoUs in [0, 1])."""
    scores, inter, area, labels = mask_case(12, 80, case)
    union = area[:, None] + area[None, :] - inter
    miou = inter / union.clamp(min=1.0)
    full = matrix_decay_plain(scores, miou, labels, kernel=kernel)
    assert torch.equal(sparse_decay(scores, miou, labels, kernel=kernel),
                       full)
    assert torch.equal(mask_matrix_decay_plain(scores, inter, area, labels,
                                               kernel=kernel), full)


@pytest.mark.parametrize('case', CASES)
def test_one_exp_a_row_matches_the_min_of_the_exps(case):
    """The kernel's gaussian takes a row's largest x = d^2 - c^2 over the
    terms whose condition holds and one exp of -sigma * x, capped at 1:
    the min of the terms' exps, since a float product by -sigma and exp
    only fall as x grows (to an ulp of exp where it is not monotone)."""
    scores, inter, area, labels = mask_case(14, 80, case)
    union = area[:, None] + area[:, None].T - inter
    miou = inter / union.clamp(min=1.0)
    on = (labels[:, None] == labels[None, :]) & \
        (scores[None, :] > scores[:, None])
    d = torch.where(on, miou, torch.zeros_like(miou))
    comp = d.amax(-1)[None, :]
    x = torch.where(on, d ** 2 - comp ** 2,
                    torch.full_like(d, float('-inf'))).amax(-1)
    low = torch.where(on.any(-1), torch.exp(-2.0 * x).clamp(max=1.0),
                      torch.ones_like(x))
    got = torch.where(scores == 0, scores, scores * low)
    want = matrix_decay_plain(scores, miou, labels)
    assert torch.equal(got == 0, want == 0)
    live = want != 0
    assert bool(((got - want).abs() <= 1e-6 * want.abs())[live].all())


def test_mask_decay_wrapper_routes_and_refuses():
    """CPU tensors take the plain version (a batch and one image alike);
    shapes that do not pair raise; the kernel's capacity covers SOLOv2's
    500 slots."""
    cases = [mask_case(13 + i, 30, 'random') for i in range(2)]
    batch = [torch.stack(t) for t in zip(*cases)]
    got = mask_matrix_decay(*batch)
    assert got.shape == (2, 30)
    for i, c in enumerate(cases):
        assert torch.equal(got[i], mask_matrix_decay(*c))
    s, inter, area, lab = cases[0]
    with pytest.raises(ValueError, match='inter'):
        mask_matrix_decay(s, inter[:-1], area, lab)
    with pytest.raises(ValueError, match='kernel'):
        mask_matrix_decay(s, inter, area, lab, kernel='box')
    assert mask_matrix_decay_capacity() >= 500
