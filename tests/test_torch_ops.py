"""Port parity: erd_tpu_torch's NMS, decode and top-k ops vs erd_tpu.

Inputs come from numpy seeds and go to both packages. NMS keep masks and
outputs and top-k indices must be exactly equal; the decode (fp32, CPU)
within rtol 1e-5 and atol 1e-4 * stride.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.ops import (batched_nms_mask as j_batched_nms_mask,
                         cap_candidates as j_cap_candidates,
                         filter_scores_and_topk as j_filter_topk,
                         integral as j_integral, nms_mask as j_nms_mask,
                         nms_select as j_nms_select)
from erd_tpu.structures import distance2bbox as j_distance2bbox
from erd_tpu_torch.ops import (batched_nms_mask, cap_candidates,
                               filter_scores_and_topk, integral,
                               integral_decode, nms_mask, nms_select,
                               nms_sorted_keep)
from erd_tpu_torch.structures import bbox_overlaps, distance2bbox

torch.set_num_threads(2)


def clustered_boxes(rs, k, n_clusters=12, size=400.0):
    """Overlapping boxes around a few centres: long suppression chains."""
    centres = rs.uniform(40, size - 40, (n_clusters, 2))
    c = centres[rs.randint(n_clusters, size=k)] + rs.normal(0, 6, (k, 2))
    wh = rs.uniform(20, 60, (k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def tied_scores(rs, k, levels=40):
    """Scores on a coarse grid, so many are exactly equal."""
    return (rs.randint(0, levels, k) / levels).astype(np.float32)


@pytest.mark.parametrize('thr', [0.3, 0.6, 0.005])
@pytest.mark.parametrize('seed', [0, 1])
def test_nms_mask_matches_jax(seed, thr):
    rs = np.random.RandomState(seed)
    k = 400
    boxes = clustered_boxes(rs, k)
    scores = tied_scores(rs, k)
    valid = rs.rand(k) > 0.15
    want = np.asarray(j_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                 thr, jnp.asarray(valid)))
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                   torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < valid.sum()


def test_batched_nms_mask_matches_jax_per_image():
    rs = np.random.RandomState(3)
    b, k, c = 3, 300, 5
    boxes = np.stack([clustered_boxes(rs, k) for _ in range(b)])
    scores = np.stack([tied_scores(rs, k) for _ in range(b)])
    labels = rs.randint(0, c, (b, k)).astype(np.int32)
    valid = rs.rand(b, k) > 0.2
    got = batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(labels).long(), 0.6,
                           torch.from_numpy(valid)).numpy()
    for i in range(b):
        want = np.asarray(j_batched_nms_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(labels[i]), 0.6, jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize('k,max_out', [(500, 100), (60, 100)])
def test_nms_select_matches_jax(k, max_out):
    rs = np.random.RandomState(k)
    boxes = clustered_boxes(rs, k)
    scores = tied_scores(rs, k)
    labels = rs.randint(0, 4, k).astype(np.int32)
    valid = rs.rand(k) > 0.1
    want = j_nms_select(jnp.asarray(boxes), jnp.asarray(scores),
                        jnp.asarray(labels), 0.6, max_out,
                        valid_mask=jnp.asarray(valid))
    got = nms_select(torch.from_numpy(boxes), torch.from_numpy(scores),
                     torch.from_numpy(labels).long(), 0.6, max_out,
                     valid_mask=torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_sorted_keep_is_serial_greedy():
    """The plain version equals the textbook serial greedy NMS."""
    rs = np.random.RandomState(7)
    k = 200
    boxes = torch.from_numpy(clustered_boxes(rs, k))
    scores = torch.from_numpy(tied_scores(rs, k))
    s, order = torch.sort(scores, descending=True, stable=True)
    sboxes = boxes[order]
    keep = nms_sorted_keep(sboxes[None], torch.ones(1, k, dtype=torch.bool),
                           order[None], 0.5)[0]
    iou = bbox_overlaps(sboxes, sboxes)
    alive = torch.ones(k, dtype=torch.bool)
    for i in range(k):
        if alive[i]:
            alive[i + 1:] &= ~(iou[i, i + 1:] > 0.5)
    np.testing.assert_array_equal(keep[order].numpy(), alive.numpy())


def test_integral_matches_jax():
    x = np.random.RandomState(0).randn(2, 50, 68).astype(np.float32) * 3
    np.testing.assert_allclose(integral(torch.from_numpy(x)).numpy(),
                               np.asarray(j_integral(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('seed', [0, 1])
def test_integral_decode_matches_jax(seed):
    rs = np.random.RandomState(seed)
    b, n, k = 2, 600, 250
    reg = (rs.randn(b, n, 68) * 3).astype(np.float32)
    rows = rs.randint(0, n, (b, k))
    strides = np.repeat(np.array([8, 16, 32], np.float32), n // 3)
    centers = rs.uniform(0, 500, (n, 2)).astype(np.float32)
    img_shape = np.array([[300, 420], [480, 260]], np.float32)
    got = integral_decode(torch.from_numpy(reg), torch.from_numpy(rows),
                          torch.from_numpy(centers),
                          torch.from_numpy(strides),
                          torch.from_numpy(img_shape)).numpy()
    for i in range(b):
        r = rows[i]
        dist = j_integral(jnp.asarray(reg[i][r])) * strides[r][:, None]
        want = np.asarray(j_distance2bbox(jnp.asarray(centers[r]), dist,
                                          max_shape=img_shape[i]))
        atol = 1e-4 * strides[r][:, None]
        assert np.all(np.abs(got[i] - want) <= atol + 1e-5 * np.abs(want))


def test_distance2bbox_matches_jax():
    rs = np.random.RandomState(2)
    pts = rs.uniform(0, 100, (30, 2)).astype(np.float32)
    dist = rs.uniform(0, 60, (30, 4)).astype(np.float32)
    want = np.asarray(j_distance2bbox(jnp.asarray(pts), jnp.asarray(dist),
                                      max_shape=(90, 70)))
    got = distance2bbox(torch.from_numpy(pts), torch.from_numpy(dist),
                        max_shape=(90, 70)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('n,c,topk', [(200, 8, 100), (30, 4, 500),
                                      (50, 3, 40)])
def test_filter_scores_and_topk_matches_jax(n, c, topk):
    rs = np.random.RandomState(n)
    scores = tied_scores(rs, n * c, levels=20).reshape(n, c)
    want = j_filter_topk(jnp.asarray(scores), 0.5, topk)
    got = filter_scores_and_topk(torch.from_numpy(scores), 0.5, topk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # batched call == per-image calls
    got_b = filter_scores_and_topk(torch.from_numpy(
        np.stack([scores, scores[::-1].copy()])), 0.5, topk)
    for g, w in zip(got_b, got):
        np.testing.assert_array_equal(g[0].numpy(), w.numpy())


def test_cap_candidates_matches_jax():
    rs = np.random.RandomState(4)
    k = 300
    scores = tied_scores(rs, k, levels=10)
    valid = rs.rand(k) > 0.6  # fewer valid than the cap: -inf ties fill
    boxes = rs.randn(k, 4).astype(np.float32)
    labels = rs.randint(0, 9, k).astype(np.int32)
    want = j_cap_candidates(jnp.asarray(scores), jnp.asarray(valid), 200,
                            jnp.asarray(boxes), jnp.asarray(labels))
    got = cap_candidates(torch.from_numpy(scores), torch.from_numpy(valid),
                         200, torch.from_numpy(boxes),
                         torch.from_numpy(labels))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
