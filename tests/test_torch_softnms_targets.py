"""Port parity on the CPU for the soft-NMS scan, CornerNet's corner-target
scalars and ``topk_stable``'s order, against erd_tpu:

- ``topk_stable`` ranks as ``jax.lax.top_k`` does: floats in IEEE
  totalOrder (NaN first, +0 before -0), ties lowest index first, bf16
  through its float32 values, integers as they are: indices and values
  exactly; DINO's query selection on logits that hold both zeros, exactly;
- the plain soft-NMS with fewer live candidates than steps: outputs
  exactly (linear) or within 1e-5 relative (gaussian, as the existing
  soft-NMS tests), and the steps past the last live candidate select
  (0, -inf), as ``jnp.argmax`` of an all -inf vector does;
- ``corner_scalars`` on boxes at and past the canvas edge, zero-size and
  inverted boxes, invalid gts between valid ones, out-of-range labels and
  two gts on one corner pixel: radius, corner pixels and offsets exactly,
  heat within 1e-6 (exp may differ by an ulp); and the float32 steps of
  the corner-target kernel (``csrc/corner_targets.cu``, with
  ``radius_consts``) repeated in numpy equal to ``corner_scalars``;
- the soft-NMS launch plan (``soft_nms_plan``): the smallest cluster whose
  blocks hold their slice and take at most 3072 slots, the smallest
  per-thread count that covers it, a raise past 8 blocks; the latency
  floor's edits fit the kernel source.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.ops.gaussian import gaussian_radius as j_gaussian_radius
from erd_tpu.ops.gaussian import render_corner_targets as j_render
from erd_tpu.ops.nms import soft_nms_select as j_soft_nms_select
from erd_tpu_torch.models.heads.dino_head import DINOHead
from erd_tpu_torch.ops import soft_nms_plain, soft_nms_select
from erd_tpu_torch.ops.gaussian import (corner_scalars, radius_consts,
                                        render_corner_targets)
from erd_tpu_torch.ops.misc import topk_stable
from erd_tpu_torch.ops.nms import (SOFT_NMS_CLUSTERS, SOFT_NMS_PER_THREAD,
                                   SOFT_NMS_SLICE, soft_nms_plan)

torch.set_num_threads(2)


def signed_zero_values(rs, shape, dtype=np.float32):
    """Seeded values with many -0 and +0 (and a few ties of other values)
    among them."""
    v = rs.randint(-3, 4, shape).astype(np.float32)
    zero = v == 0
    v[zero] = np.where(rs.rand(int(zero.sum())) < 0.5, -0.0, 0.0)
    return v.astype(dtype)


@pytest.mark.parametrize('case', ['issue', 'float32', 'float32_k',
                                  'bfloat16', 'batch', 'int'])
def test_topk_stable_matches_lax_top_k(case):
    rs = np.random.RandomState(3)
    if case == 'issue':
        v, k = np.array([-0.0, 0.0, -0.0, 0.0, 1.0, np.nan], np.float32), 6
    elif case == 'float32':
        v, k = signed_zero_values(rs, (257,)), 257
    elif case == 'float32_k':
        v, k = signed_zero_values(rs, (300,)), 40
        v[[5, 77]] = [np.nan, -np.inf]
    elif case == 'bfloat16':
        v, k = signed_zero_values(rs, (200,)), 150
    elif case == 'batch':
        v, k = signed_zero_values(rs, (4, 90)), 30
    else:
        v, k = rs.randint(-5, 5, (3, 50)).astype(np.int32), 20
    if case == 'bfloat16':
        jv = jnp.asarray(v, jnp.bfloat16)
        tv = torch.from_numpy(v).to(torch.bfloat16)
    else:
        jv, tv = jnp.asarray(v), torch.from_numpy(v)
    want_v, want_i = jax.lax.top_k(jv, k)
    got_v, got_i = topk_stable(tv, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_v.dtype == tv.dtype
    got_v = got_v.float().numpy() if case == 'bfloat16' else got_v.numpy()
    want_v = np.asarray(want_v.astype(jnp.float32) if case == 'bfloat16'
                        else want_v)
    np.testing.assert_array_equal(got_v, want_v)
    if v.dtype.kind == 'f':  # the signs of the zeros too
        np.testing.assert_array_equal(np.signbit(got_v), np.signbit(want_v))
    if case == 'issue':
        assert got_i.tolist() == [5, 4, 1, 3, 0, 2]


def test_dino_select_matches_jax_on_signed_zeros():
    """DINO's mixed query selection ranks the tokens' max class logits;
    where those are -0 and +0 the port picks erd_tpu's tokens
    (``heads/dino_head.py``: ``jax.lax.top_k(enc_cls.max(axis=-1), k)``)."""
    rs = np.random.RandomState(5)
    b, t, c, k = 2, 120, 7, 50
    logits = -rs.uniform(0.5, 3.0, (b, t, c)).astype(np.float32)
    top = rs.randint(c, size=(b, t))
    sign = rs.rand(b, t) < 0.5
    # most tokens' largest logit is a zero of either sign, the rest < 0
    zero = rs.rand(b, t) < 0.7
    np.put_along_axis(logits, top[..., None], np.where(
        zero, np.where(sign, -0.0, 0.0), -0.25)[..., None].astype(
            np.float32), -1)
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits).max(axis=-1), k)[1])
    got = DINOHead.select(SimpleNamespace(num_queries=k),
                          torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    # the zeros' signs decide the order: the old tie order differs
    old = torch.sort(torch.from_numpy(logits).amax(-1), dim=-1,
                     descending=True, stable=True)[1][:, :k]
    assert not np.array_equal(old.numpy(), want)


@pytest.mark.parametrize('method', ['linear', 'gaussian'])
def test_soft_nms_fewer_live_than_steps_matches_jax(method):
    """K = 64 candidates of which 9 are live, 40 steps: the plain scan
    matches erd_tpu's, and once nothing is live every step selects
    (0, -inf), jnp.argmax's answer on an all -inf vector."""
    rs = np.random.RandomState(11)
    k, live, max_out = 64, 9, 40
    xy = rs.uniform(0, 200, (k, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(10, 80, (k, 2))],
                           -1).astype(np.float32)
    scores = rs.uniform(0.05, 1.0, k).astype(np.float32)
    labels = rs.randint(0, 3, k).astype(np.int32)
    valid = np.zeros(k, bool)
    valid[rs.choice(k, live, replace=False)] = True
    kw = dict(iou_threshold=0.3, sigma=0.5, min_score=1e-3, method=method)
    want = jax.jit(lambda bx, s, lab, v: j_soft_nms_select(
        bx, s, lab, max_out, valid_mask=v, **kw))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        jnp.asarray(valid))
    got = soft_nms_select(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(labels).long(), max_out,
                          valid_mask=torch.from_numpy(valid), **kw)
    wb, ws, wl, wm = (np.asarray(a) for a in want)
    assert int(wm.sum()) == live
    np.testing.assert_array_equal(got[3].numpy(), wm)
    np.testing.assert_array_equal(got[2].numpy(), wl)
    np.testing.assert_array_equal(got[0].numpy(), wb)
    np.testing.assert_allclose(got[1].numpy(), ws, atol=0,
                               rtol=0 if method == 'linear' else 1e-5)
    # the raw scan: past the live candidates, (0, -inf) at every step
    cur = torch.where(torch.from_numpy(valid), torch.from_numpy(scores),
                      torch.tensor(float('-inf')))
    idx, sel = soft_nms_plain(torch.from_numpy(boxes)[None], cur[None],
                              max_out, 0.3, 0.5, 1e-3, method)
    assert int(jnp.argmax(jnp.full((k,), -jnp.inf))) == 0
    assert bool((sel[0, live:] == float('-inf')).all())
    assert bool((idx[0, live:] == 0).all())
    assert bool((sel[0, :live] > float('-inf')).all())


CANVAS = (64, 96)   # (H, W); the maps are 16 x 24
EDGE_BOXES = [
    [0, 0, 96, 64],            # the whole canvas: corners on the last pixel
    [-10, -6, 110, 80],        # past every edge: the tl corner off the map
    [40, 30, 40, 30],          # zero size: radius 0
    [10.3, 10.3, 10.9, 10.9],  # smaller than a pixel
    [20, 20, 60, 50],          # two gts on one tl corner pixel ...
    [21, 21, 70, 55],          # ... (a later one wins the offsets)
    [50, 40, 30, 20],          # inverted
    [-300, -200, 500, 400],    # far past the edges
    [95.9, 63.9, 96, 64],      # at the bottom-right corner
    [3, 4, 95, 2],             # inverted in y only
]
EDGE_LABELS = [0, 1, 2, 7, 3, 3, -2, 1, 0, 2]   # 7 and -2 out of range
EDGE_VALID = [1, 1, 1, 0, 1, 1, 1, 0, 1, 1]     # invalid between valid


def edge_batch():
    rs = np.random.RandomState(4)
    boxes = np.zeros((2, 12, 4), np.float32)
    labels = np.zeros((2, 12), np.int32)
    valid = np.zeros((2, 12), bool)
    n = len(EDGE_BOXES)
    boxes[0, :n] = EDGE_BOXES
    labels[0, :n] = EDGE_LABELS
    valid[0, :n] = EDGE_VALID
    xy = rs.uniform(-20, 90, (12, 2))
    boxes[1] = np.concatenate([xy, xy + rs.uniform(0, 60, (12, 2))], -1)
    labels[1] = rs.randint(-1, 6, 12)
    valid[1] = rs.rand(12) < 0.7
    return boxes, labels, valid


def test_corner_scalars_on_edge_boxes_match_jax():
    boxes, labels, valid = edge_batch()
    fh, fw = CANVAS[0] // 4, CANVAS[1] // 4
    ratio = (fw / CANVAS[1], fh / CANVAS[0])
    jratio = jnp.asarray(ratio, jnp.float32)
    want = jax.jit(jax.vmap(lambda b, lab, m: j_render(
        b, lab, m, (fh, fw), 4, jratio)))(boxes, labels, valid)

    def j_radius(b):  # erd_tpu's radius, as its render computes it
        sl, st = b[..., 0] * jratio[0], b[..., 1] * jratio[1]
        sr, sb = b[..., 2] * jratio[0], b[..., 3] * jratio[1]
        return jnp.clip(jnp.floor(j_gaussian_radius(
            jnp.ceil(sb - st), jnp.ceil(sr - sl))), 0.0, None).astype(
            jnp.int32)
    tb, tl, tv = (torch.from_numpy(a) for a in (boxes, labels, valid))
    sc = corner_scalars(tb, tl, tv, (fh, fw), 4, ratio)
    np.testing.assert_array_equal(sc['radius'].numpy(),
                                  np.asarray(jax.jit(j_radius)(boxes)))
    assert int(sc['radius'][0, 2]) == 0 and int(sc['tl_x'][0, 1]) == -2
    np.testing.assert_array_equal(sc['label'][0, :7].numpy(),
                                  [0, 1, 2, 3, 3, 3, 0])
    got = render_corner_targets(tb, tl, tv, (fh, fw), 4, ratio)
    for c in ('tl', 'br'):
        w_heat = np.asarray(want[f'{c}_heat'])
        g_heat = got[f'{c}_heat'].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g_heat, w_heat, rtol=0, atol=1e-6)
        assert int((got[f'{c}_heat'] == 1).sum()) == int((w_heat == 1).sum())
        for k in ('off', 'w'):
            np.testing.assert_array_equal(
                got[f'{c}_{k}'].permute(0, 2, 3, 1).numpy(),
                np.asarray(want[f'{c}_{k}']))
        np.testing.assert_array_equal(got[f'{c}_xy'].numpy(),
                                      np.asarray(want[f'{c}_xy']))
    # the later of the two gts on tl pixel (5, 5) holds its offsets
    np.testing.assert_array_equal(got['tl_off'][0, :, 5, 5].numpy(),
                                  sc['tl_off'][0, 5].numpy())


def kernel_scalars_np(boxes, labels, valid, feat_hw, num_classes, ratio):
    """The per-gt scalars as csrc/corner_targets.cu computes them, each
    float32 op rounded on its own (numpy float32, no fused multiply-add),
    from ``radius_consts``."""
    f = np.float32
    k1, c07, cm06, cm07, c48, k3, csig, eps = (f(v) for v in
                                               radius_consts(0.3))
    fh, fw = feat_hw
    rx, ry = f(ratio[0]), f(ratio[1])
    sl, st = boxes[..., 0] * rx, boxes[..., 1] * ry
    sr, sb = boxes[..., 2] * rx, boxes[..., 3] * ry

    def trunc(v, cap):
        return np.where(v > f(cap), f(cap), v).astype(np.int32)

    def sqrt0(v):
        return np.sqrt(np.where(v < 0, f(0), v))
    w, h = np.ceil(sr - sl), np.ceil(sb - st)
    b1 = h + w
    r1 = (b1 - sqrt0(b1 * b1 - (w * h) * k1)) * f(0.5)
    b2 = b1 * f(2)
    r2 = (b2 - sqrt0(b2 * b2 - ((w * c07) * h) * f(16))) * f(0.125)
    b3 = b1 * cm06
    c3 = (w * cm07) * h
    r3 = (-b3 + sqrt0(b3 * b3 - c3 * c48)) * k3
    r = np.floor(np.minimum(np.minimum(r1, r2), r3))
    r = np.where(r < 0, f(0), r).astype(np.int32)
    side = f(2) * r.astype(np.float32) + f(1)
    li, ti, ri, bi = (trunc(sl, fw - 1), trunc(st, fh - 1),
                      trunc(sr, fw - 1), trunc(sb, fh - 1))
    return dict(tl_x=li, tl_y=ti, br_x=ri, br_y=bi, radius=r,
                denom=(side * side) * csig + eps,
                tl_off=np.stack([sl - li.astype(np.float32),
                                 st - ti.astype(np.float32)], -1),
                br_off=np.stack([sr - ri.astype(np.float32),
                                 sb - bi.astype(np.float32)], -1),
                label=np.clip(labels, 0, num_classes - 1), valid=valid)


def test_corner_kernel_scalar_order_matches_corner_scalars():
    """The kernel's float32 order and constants give ``corner_scalars``'s
    values bit for bit: the edge batch, random boxes over 300 px, and box
    sizes whose radius sits near an integer."""
    boxes, labels, valid = edge_batch()
    rs = np.random.RandomState(12)
    xy = rs.uniform(-50, 700, (3, 400, 2))
    more = np.concatenate([xy, xy + rs.uniform(0, 300, (3, 400, 2))],
                          -1).astype(np.float32)
    cases = [(boxes, labels, valid, (16, 24), (0.25, 0.25)),
             (more, rs.randint(-3, 90, (3, 400)), rs.rand(3, 400) < 0.8,
              (192, 256), (256 / 1024, 192 / 768))]
    for bx, lab, v, hw, ratio in cases:
        want = corner_scalars(*(torch.from_numpy(np.asarray(a)) for a in
                                (bx, lab, v)), hw, 80, ratio)
        got = kernel_scalars_np(bx, lab, v, hw, 80, ratio)
        for key, g in got.items():
            np.testing.assert_array_equal(g, want[key].numpy(), err_msg=key)


def capacities(one=10426, step=93):
    return {cs: one - step * i for i, cs in enumerate(SOFT_NMS_CLUSTERS)}


@pytest.mark.parametrize('threads', [1024, 512, 256])
@pytest.mark.parametrize('k', [1, 1024, 1025, 2000, 3072, 3073, 3881, 6145,
                               8193, 10000, 10426, 10427, 12000, 12289,
                               20667, 40000, 77000])
def test_soft_nms_plan(k, threads):
    """The smallest cluster whose blocks each hold their slice of
    ceil(K / size) and take at most SOFT_NMS_SLICE (8 blocks any slice they
    hold), and the smallest compiled per-thread count covering a slice
    (the counts scale by 1024 / threads)."""
    cap = capacities()
    cs, slice_, per = soft_nms_plan(k, cap, threads)
    counts = [p * 1024 // threads for p in SOFT_NMS_PER_THREAD]

    def fits(c):
        s = -(-k // c)
        return s <= cap[c] and (s <= SOFT_NMS_SLICE or
                                c == SOFT_NMS_CLUSTERS[-1])
    assert cs in SOFT_NMS_CLUSTERS and slice_ == -(-k // cs)
    assert fits(cs) and not any(fits(c) for c in SOFT_NMS_CLUSTERS
                                if c < cs)
    assert per in counts and per * threads >= slice_
    assert all(p * threads < slice_ for p in counts if p < per)
    if k <= SOFT_NMS_SLICE:
        assert cs == 1
    if k in (10000, 12000):
        assert (cs, slice_) == (4, -(-k // 4))


def test_soft_nms_plan_of_one_cluster_size():
    """``clusters=(size,)``: that size whatever the slice (the probe's
    forced plans), and a raise where its blocks cannot hold the slice."""
    cap = capacities()
    assert soft_nms_plan(10000, cap, 512, clusters=(1,)) == (1, 10000, 22)
    assert soft_nms_plan(2000, cap, 512, clusters=(8,)) == (8, 250, 2)
    with pytest.raises(ValueError, match='exceeds a cluster of 1 blocks'):
        soft_nms_plan(cap[1] + 1, cap, 512, clusters=(1,))


def test_soft_nms_plan_raises_past_eight_blocks():
    cap = capacities()
    most = SOFT_NMS_CLUSTERS[-1]
    assert soft_nms_plan(most * cap[most], cap)[0] == most
    with pytest.raises(ValueError, match='exceeds a cluster of 8 blocks'):
        soft_nms_plan(most * cap[most] + 1, cap)


def test_soft_nms_floor_edits_fit_the_kernel_source():
    """The latency floor (``chip_smoke.SOFT_NMS_FLOOR_EDITS``) and the
    probe's floor parts (``SOFT_NMS_FLOOR_PARTS``, on top of it) are
    edited copies of csrc/soft_nms.cu: every text is in the source and
    each replacement changes it."""
    import importlib

    from erd_tpu_torch.ops import cuda_build
    from erd_tpu_torch.tools import atomic_backward_probe as probe
    smoke = importlib.import_module('chip_smoke')
    src = (cuda_build.CSRC / 'soft_nms.cu').read_text()
    for old, new in smoke.SOFT_NMS_FLOOR_EDITS.items():
        assert old in src and old != new
        src = src.replace(old, new)
    for part, edits in probe.SOFT_NMS_FLOOR_PARTS.items():
        assert all(old in src and old != new for old, new in edits.items()), \
            part
