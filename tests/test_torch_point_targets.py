"""Port parity of the point-sample forward and the mask targets at the calls
of a PointRend and a Mask R-CNN training step, on the CPU, and the
forward kernel's layout plan (``point_sample_plan``).

Inputs are made with numpy from seeds, at reduced counts but the calls'
forms: one-channel 14x14 maps at 588 and 196 points a map (PointRend's
uncertainty and target calls), 80 channels-last float32 14x14 maps (its
coarse call), a channels-last bf16 P2 with a multiple of 8 channels (its
fine call). Tolerances, each with its reason:
- point_sample against erd_tpu's: 1e-6 * max|map|, the same bilinear
  arithmetic (XLA may fuse a product and a sum); bf16 maps are widened to
  float32 on both sides;
- the mask targets: exactly, as tests/test_torch_mask_train.py (the plain
  version repeats XLA's folded reciprocal and fused multiply-adds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.data.masks import crop_resize_mask as j_crop_resize_mask
from erd_tpu.ops.sampling import point_sample as j_point_sample
from erd_tpu_torch.data.masks import crop_resize_mask, crop_resize_mask_plain
from erd_tpu_torch.ops.sampling import (INDEX_LIMIT, POINT_LAYOUTS,
                                        STAGE_BYTES, STAGE_MAPS,
                                        point_sample, point_sample_plain,
                                        point_sample_plan)

torch.set_num_threads(2)


# ------------------------------------------------- point-sample forward
def train_points(rs, n, k):
    """Points of a training call: uniform over [-0.05, 1.05]^2 (some
    samples with corners off the map), then the edges 0 and 1, cell
    centres and pixel centres (weights 0 and 1)."""
    pts = rs.uniform(-0.05, 1.05, (n, k, 2)).astype(np.float32)
    pts[:, :8] = np.asarray([[0, 0], [1, 1], [0, 1], [1, 0], [0, 0.5],
                             [0.5, 1], [1 / 28, 27 / 28], [0.5, 0.5]],
                            np.float32)
    return pts


def train_form(rs, form):
    """(NHWC float32 maps as erd_tpu takes them, the port's maps in the
    call's dtype and layout, points) of one training call form."""
    if form in ('uncertainty', 'targets'):
        k = 588 if form == 'uncertainty' else 196
        maps = rs.randn(6, 14, 14, 1) * 3 if form == 'uncertainty' else \
            rs.rand(6, 14, 14, 1)
        dtype, channels_last = torch.float32, False
        pts = train_points(rs, 6, k)
    elif form == 'coarse':
        maps, dtype, channels_last = rs.randn(4, 14, 14, 80) * 3, \
            torch.float32, True
        pts = train_points(rs, 4, 196)
    else:
        maps, dtype, channels_last = rs.randn(2, 24, 32, 16) * 3, \
            torch.bfloat16, True
        pts = train_points(rs, 2, 6 * 196)
    tmaps = torch.from_numpy(maps.astype(np.float32)).to(dtype)
    jmaps = tmaps.float().numpy()  # bf16 values widened, as both sides
    tmaps = tmaps.permute(0, 3, 1, 2)
    if not channels_last:
        tmaps = tmaps.contiguous()
    return jmaps, tmaps, torch.from_numpy(pts)


@pytest.mark.parametrize('form', ['uncertainty', 'coarse', 'fine',
                                  'targets'])
def test_point_sample_plain_matches_jax_at_training_forms(form):
    """Each of PointRend's four training call forms against erd_tpu's
    point_sample, map by map; the wrapper (the plain version on the CPU)
    equal to plain, and the maps' other memory layout read the same."""
    jmaps, maps, pts = train_form(np.random.RandomState(4), form)
    want = np.stack([np.asarray(j_point_sample(jnp.asarray(m),
                                               jnp.asarray(p)))
                     for m, p in zip(jmaps, pts.numpy())])
    got = point_sample_plain(maps, pts)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert torch.equal(point_sample(maps, pts), got)
    other = maps.contiguous() if form in ('coarse', 'fine') else \
        maps.contiguous(memory_format=torch.channels_last)
    assert torch.equal(point_sample_plain(other, pts), got)


P2_CL = (17203200, 1, 86016, 256)
LOGITS_CL = (15680, 1, 1120, 80)
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize('case,shape,strides,dtype,k,address,want', [
    # the four training calls of a bs-16 PointRend step
    ('t1 uncertainty', (8192, 1, 14, 14), (196, 196, 14, 1), F32, 588, 0,
     ('staged', STAGE_MAPS, True, False)),
    ('t2 coarse', (8192, 80, 14, 14), LOGITS_CL, F32, 196, 0,
     ('staged', 1, True, False)),
    ('t3 fine', (16, 256, 200, 336), P2_CL, BF16, 100352, 0,
     ('unit', 1, False, False)),
    ('t4 targets', (8192, 1, 14, 14), (196, 196, 14, 1), F32, 196, 0,
     ('staged', STAGE_MAPS, True, False)),
    # the two call shapes of a request
    ('serve coarse', (100, 80, 14, 14), LOGITS_CL, F32, 196, 0,
     ('unit', 1, False, False)),
    ('few NCHW coarse maps', (100, 80, 14, 14), (15680, 196, 14, 1), F32,
     196, 0, ('staged', 1, False, False)),
    ('serve fine', (1, 256, 200, 336), P2_CL, BF16, 19600, 0,
     ('unit', 1, False, False)),
    # layouts no model path gives
    ('NCHW P2', (1, 256, 200, 336), (17203200, 67200, 336, 1), BF16, 19600,
     0, ('general', 1, False, False)),
    ('P2 off 16 bytes', (1, 256, 200, 336), P2_CL, BF16, 19600, 2,
     ('general', 1, False, False)),
    ('one channel of channels-last logits', (8192, 1, 14, 14), LOGITS_CL,
     F32, 588, 0, ('staged', STAGE_MAPS, False, False)),
    ('a map off 16 bytes, staged', (8192, 1, 14, 14), (196, 196, 14, 1),
     F32, 196, 4, ('staged', STAGE_MAPS, False, False)),
    ('float32 channels-last P2', (2, 256, 50, 84), (1075200, 1, 21504, 256),
     F32, 1960, 0, ('unit', 1, False, False)),
    ('past 32-bit indices', (128, 256, 200, 336), P2_CL, BF16, 100352, 0,
     ('unit', 1, False, True)),
])
def test_point_sample_plan_picks_the_layouts(case, shape, strides, dtype, k,
                                             address, want):
    """The plan stages PointRend's 14x14 maps of a training step (one
    channel: 8 maps a block; 80 channels: 62.7 KB and a block a map), but
    a request's 100 channels-last coarse maps (fewer blocks than
    STAGE_MIN_BLOCKS) go by unit-stride channels where they can, takes the
    bf16 channels-last P2 by unit-stride channels in 32-bit index math, and
    sends NCHW or misaligned P2 maps to the general layout; a map that is
    not dense in (H, W, C) order or off 16 bytes is staged element by
    element; 64-bit indices past 2^31 - 2^20. It never names the plain
    version, and every staged block fits STAGE_BYTES."""
    plan = point_sample_plan(shape, strides, dtype, k, address)
    assert (plan.layout, plan.maps_per_block, plan.vec_copy,
            plan.wide) == want, case
    assert plan.layout in POINT_LAYOUTS
    n, c, h, w = shape
    if plan.layout == 'staged':
        per_map = -(-c * h * w * (2 if dtype == BF16 else 4) // 16) * 16 + \
            (24 * k if c > 1 else 0)
        assert plan.maps_per_block * per_map <= STAGE_BYTES
        assert plan.maps_per_block * k * c < INDEX_LIMIT
    if plan.layout == 'general':
        assert plan.active_lanes == c / -(-c // 32)
    else:
        assert plan.active_lanes == 32.0


# ---------------------------------------------------------- mask targets
def gt_crops(rs, n):
    """n 56x56 uint8 crops: an ellipse each, with noise flipped in."""
    yy, xx = np.mgrid[:56, :56] + 0.5
    out = []
    for _ in range(n):
        cy, cx = rs.uniform(18, 38, 2)
        ry, rx = rs.uniform(10, 28, 2)
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        m ^= rs.rand(56, 56) < 0.03
        out.append(m.astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize('out_size', [28, 14])
@pytest.mark.parametrize('s', [13, 37])
def test_crop_resize_mask_matches_jax_across_blocks(out_size, s):
    """Runs of RoIs that end inside the kernel's runs of RoIs (a warp takes
    1 at 28 and 3 at 14, a block 8 warps), RoIs far off their gt (1e5
    px), on it and tiny, degenerate gt boxes: equal to erd_tpu's jitted
    crop_resize_mask to the bit, with int64 and int32 gt indices alike."""
    rs = np.random.RandomState(out_size + s)
    b, g = 3, 4
    xy = rs.uniform(0, 300, (b, g, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(2, 200, (b, g, 2))], -1)
    boxes[0, 1] = [20, 20, 20, 20]          # a point
    boxes[1, 2] = [10, 40, 80, 40.0005]     # a line
    boxes = boxes.astype(np.float32)
    masks = np.stack([gt_crops(rs, g) for _ in range(b)])
    idx = rs.randint(0, g, (b, s))
    gt_xy = boxes[np.arange(b)[:, None], idx, :2]
    rois = np.concatenate([gt_xy - 30 + rs.uniform(0, 60, (b, s, 2))] * 2,
                          -1)
    rois[..., 2:] += rs.uniform(0, 250, (b, s, 2))
    rois[0, 0] = [-1e5, -1e5, -9e4, -9e4]
    rois[-1, -1] = [1e5, 1e5, 2e5, 2e5]
    rois[1, 0] = [21, 21, 21.5, 21.2]
    rois = rois.astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda gm, gb, gi, rr: jax.vmap(
        lambda i, r: j_crop_resize_mask(gm[i], gb[i], r, out_size))(
        gi, rr)))(masks, boxes, idx, rois))
    assert 0 < (want > 0).mean() < 0.9 and (want == 0).any()
    for index in (np.int64, np.int32):
        args = [torch.from_numpy(a) for a in (masks, boxes,
                                              idx.astype(index), rois)]
        got = crop_resize_mask(*args, out_size)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, crop_resize_mask_plain(*args, out_size))
