"""Port parity: matrix NMS, fast NMS, nms_match and the masked convolution
(the plain versions of the kernels in erd_tpu_torch/csrc/extra_nms.cu and
csrc/masked_conv.cu) against erd_tpu, float32 on the CPU, and the kernel
wrappers' routing.

Tolerances, each with its reason:
- keep masks, leaders: exactly (the IoUs are rounded op for op as
  erd_tpu's, and the comparisons are strict or inclusive as there);
- decayed scores: rtol 1e-6 (an exp or a division of the same float32
  terms, which may differ from XLA's by an ulp);
- the masked conv: rtol 1e-5 of max|out| on inputs from a 1/64 grid
  (products exact, sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.ops import extra_nms as j_extra
from erd_tpu.ops.sampling import masked_conv2d as j_masked_conv2d
from erd_tpu_torch.ops import (fast_nms, fast_nms_keep, masked_conv2d,
                               masked_conv2d_plain, matrix_decay,
                               matrix_decay_plain, matrix_nms, nms_match,
                               nms_match_leader, nms_sorted_keep)

torch.set_num_threads(2)

TEST_OPS_BOXES = np.asarray([[0, 0, 50, 50], [1, 1, 51, 51],
                             [200, 200, 250, 250]], np.float32)
MATCH_BOXES = np.asarray([[0., 0., 10., 10.], [1., 1., 11., 11.],
                          [50., 50., 60., 60.], [51., 50., 61., 60.],
                          [200., 200., 210., 210.]], np.float32)


def tied_case(seed, n, num_labels=3):
    """Clustered boxes on a 1/4-pixel grid with exact duplicates (tied
    IoUs), scores on a 1/8 grid (tied scores), a few invalid slots."""
    rs = np.random.RandomState(seed)
    centres = rs.uniform(20, 200, (4, 2))
    c = centres[rs.randint(4, size=n)] + rs.normal(0, 6, (n, 2))
    wh = rs.uniform(10, 50, (n, 2))
    boxes = np.round(np.concatenate([c - wh / 2, c + wh / 2], -1) * 4) / 4
    dup = rs.rand(n) < 0.2
    boxes[dup] = boxes[rs.randint(n, size=int(dup.sum()))]
    scores = (rs.randint(0, 8, n) / 8).astype(np.float32)
    labels = rs.randint(0, num_labels, n).astype(np.int32)
    valid = rs.rand(n) > 0.1
    return boxes.astype(np.float32), scores, labels, valid


def t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ matrix NMS
@pytest.mark.parametrize('kernel', ['gaussian', 'linear'])
def test_matrix_nms_plain_matches_erd_tpu_on_test_ops_case(kernel):
    scores = np.asarray([0.9, 0.8, 0.7], np.float32)
    labels = np.zeros(3, np.int32)
    want = np.asarray(j_extra.matrix_nms(
        jnp.asarray(TEST_OPS_BOXES), jnp.asarray(scores), jnp.asarray(labels),
        kernel=kernel))
    got = matrix_nms(t(TEST_OPS_BOXES), t(scores), t(labels).long(),
                     kernel=kernel)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert got[0] == pytest.approx(0.9) and got[1] < 0.8


@pytest.mark.parametrize('kernel', ['gaussian', 'linear'])
@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('masked', [False, True])
def test_matrix_nms_plain_matches_erd_tpu_with_ties(kernel, seed, masked):
    boxes, scores, labels, valid = tied_case(seed, 60)
    kw = dict(valid_mask=valid) if masked else {}
    want = np.asarray(j_extra.matrix_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        sigma=2.0, kernel=kernel,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = matrix_nms(t(boxes), t(scores), t(labels).long(), sigma=2.0,
                     kernel=kernel, **{k: t(v) for k, v in kw.items()})
    assert (want < scores).any() and (want == 0).any() == (
        (scores == 0).any() or masked)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # a batch of two images gives each image's own result
    got2 = matrix_nms(t(np.stack([boxes, boxes[::-1]])),
                      t(np.stack([scores, scores[::-1]])),
                      t(np.stack([labels, labels[::-1]])).long(), sigma=2.0,
                      kernel=kernel, **{k: t(np.stack([v, v[::-1]]))
                                        for k, v in kw.items()})
    np.testing.assert_array_equal(got2[0].numpy(), got.numpy())


def solov2_decay(scores, miou, labels, sigma):
    """erd_tpu/models/detectors/solov2.py:404-410, run through JAX."""
    same = labels[:, None] == labels[None, :]
    higher = scores[None, :] > scores[:, None]
    decay_iou = jnp.where(same & higher, miou, 0.0)
    comp = decay_iou.max(axis=1)
    decay = jnp.exp(-sigma * (decay_iou ** 2 - comp[None, :] ** 2))
    return scores * decay.min(axis=1)


@pytest.mark.parametrize('seed', [0, 3])
def test_matrix_decay_on_a_mask_iou_matches_solov2s_formula(seed):
    """SOLOv2's call: binary masks' IoU (exact on 0/1), half the slots
    scored 0 (ties that never decay each other), equal masks (tied IoUs)."""
    rs = np.random.RandomState(seed)
    n = 48
    masks = rs.rand(n, 12, 16) < rs.uniform(0.1, 0.6, (n, 1, 1))
    masks[rs.randint(n, size=6)] = masks[rs.randint(n, size=6)]
    m = masks.reshape(n, -1).astype(np.float32)
    area = m.sum(1)
    inter = m @ m.T
    miou = (inter / np.maximum(area[:, None] + area[None, :] - inter, 1.0)
            ).astype(np.float32)
    scores = np.where(rs.rand(n) < 0.5, 0.0,
                      rs.randint(1, 6, n) / 6).astype(np.float32)
    labels = rs.randint(0, 3, n).astype(np.int32)
    want = np.asarray(solov2_decay(jnp.asarray(scores), jnp.asarray(miou),
                                   jnp.asarray(labels), 2.0))
    got = matrix_decay(t(scores), t(miou), t(labels).long(), 2.0)
    assert (want < scores).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # for a symmetric IoU the box form's formula is the same function
    np.testing.assert_array_equal(
        matrix_decay_plain(t(scores), t(miou).T, t(labels)).numpy(),
        got.numpy())


# -------------------------------------------------------------- fast NMS
def test_fast_nms_matches_erd_tpu_on_test_ops_case(rng):
    from tests.conftest import rand_boxes
    boxes = rand_boxes(rng, 40, w=100, h=100)
    scores = rng.rand(40).astype(np.float32)
    labels = np.zeros(40, np.int32)
    want = np.asarray(j_extra.fast_nms(jnp.asarray(boxes),
                                       jnp.asarray(scores),
                                       jnp.asarray(labels), 0.5))
    got = fast_nms(t(boxes), t(scores), t(labels), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('masked', [False, True])
def test_fast_nms_matches_erd_tpu_with_ties(seed, masked):
    boxes, scores, labels, valid = tied_case(seed, 80)
    kw = dict(valid_mask=valid) if masked else {}
    want = np.asarray(j_extra.fast_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), 0.5,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = fast_nms(t(boxes), t(scores), t(labels), 0.5,
                   **{k: t(v) for k, v in kw.items()})
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- nms_match
def test_nms_match_matches_erd_tpu_on_test_ops_case():
    scores = np.asarray([0.9, 0.7, 0.8, 0.6, 0.5], np.float32)
    jk, jl = j_extra.nms_match(jnp.asarray(MATCH_BOXES), jnp.asarray(scores),
                               0.5)
    keep, leader = nms_match(t(MATCH_BOXES), t(scores), 0.5)
    assert keep.tolist() == [True, False, True, False, True]
    assert leader.tolist() == [0, 0, 2, 2, 4]
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(leader.numpy(), np.asarray(jl))


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('masked', [False, True])
def test_nms_match_matches_erd_tpu_with_ties(seed, masked):
    """Tied scores among overlapping kept boxes: the leader is the lowest
    index of the highest score, as argmax takes it; invalid slots -1."""
    boxes, scores, _, valid = tied_case(seed, 80)
    kw = dict(valid_mask=valid) if masked else {}
    jk, jl = j_extra.nms_match(jnp.asarray(boxes), jnp.asarray(scores), 0.3,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    keep, leader = nms_match(t(boxes), t(scores), 0.3,
                             **{k: t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(leader.numpy(), np.asarray(jl))
    lead = leader.numpy()
    assert (lead[keep.numpy()] == np.flatnonzero(keep.numpy())).all()
    if masked:
        assert (lead[~valid] == -1).all()


# --------------------------------------------------------- masked conv
@pytest.mark.parametrize('k', [1, 3, 5])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('bias', [False, True])
def test_masked_conv2d_plain_matches_erd_tpu(k, stride, bias):
    rs = np.random.RandomState(10 * k + stride)
    x = np.round(rs.randn(2, 11, 13, 6) * 64) / 64
    w = np.round(rs.randn(k, k, 6, 5) * 16) / 64
    b = np.round(rs.randn(5) * 64) / 64 if bias else None
    ho, wo = (11 - 1) // stride + 1, (13 - 1) // stride + 1
    mask = rs.rand(2, ho, wo) < 0.4
    want = np.asarray(j_masked_conv2d(
        jnp.asarray(x, jnp.float32), jnp.asarray(mask),
        jnp.asarray(w, jnp.float32),
        None if b is None else jnp.asarray(b, jnp.float32), stride=stride))
    got = masked_conv2d(t(x).float().permute(0, 3, 1, 2), t(mask),
                        t(w).float().permute(3, 2, 0, 1),
                        None if b is None else t(b).float(), stride=stride)
    assert got.dtype == torch.float32 and got.shape == (2, 5, ho, wo)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert (got[~mask] == 0).all() and (got[mask] != 0).any()


def test_masked_conv2d_rejects_wrong_shapes():
    x = torch.zeros(1, 4, 8, 8)
    w = torch.zeros(3, 4, 3, 3)
    with pytest.raises(ValueError, match='mask'):
        masked_conv2d(x, torch.ones(1, 4, 4), w)
    with pytest.raises(ValueError, match='weight'):
        masked_conv2d(x, torch.ones(1, 8, 8), torch.zeros(3, 5, 3, 3))


@pytest.mark.parametrize('p,co,tile', [(16800, 256, 3), (8391, 256, 1),
                                        (4272, 256, 2), (848, 256, 2),
                                        (16800, 128, 1), (0, 256, 2),
                                        (6300, 256, 2), (8300, 256, 1),
                                        (8500, 256, 2), (12000, 256, 3),
                                        (16700, 256, 3), (20000, 256, 1),
                                        (33600, 256, 3)])
def test_masked_conv_tile_is_the_largest_that_fills_the_card(p, co, tile):
    """On 132 SMs, the tile whose launch MASKED_CONV_TILE_COST puts
    shortest: at Co = 256 the tile an H100 ran fastest at each of these P
    (erd_tpu_torch/tools/masked_conv_tiles.py), on both sides of every
    change of choice (8448 | 8500: 128 x 128 past one block an SM loses to
    64 x 64); 128 x 256 only for Co > 128; 64 x 64 at P = 0."""
    from erd_tpu_torch.ops.sampling import (MASKED_CONV_TILES,
                                            masked_conv_tile)
    assert masked_conv_tile(p, co, 132) == tile
    assert tile in MASKED_CONV_TILES


# --------------------------------------------- routing and launch counts
def test_wrappers_route_cpu_to_plain_and_never_fall_back():
    """CPU tensors take the plain versions and count no launch; any other
    device launches the kernel or raises (here: no kernel for meta)."""
    counters = (matrix_decay, matrix_nms, fast_nms_keep, nms_match_leader,
                masked_conv2d, nms_sorted_keep)
    before = [c.launches for c in counters]
    boxes, scores, labels, valid = tied_case(5, 20)
    matrix_nms(t(boxes), t(scores), t(labels))
    matrix_decay(t(scores), torch.rand(20, 20), t(labels))
    fast_nms(t(boxes), t(scores), t(labels), 0.5)
    nms_match(t(boxes), t(scores), 0.5)
    x, w = torch.randn(1, 3, 6, 6), torch.randn(4, 3, 3, 3)
    mask = torch.rand(1, 6, 6) < 0.5
    assert torch.equal(masked_conv2d(x, mask, w),
                       masked_conv2d_plain(x, mask, w))
    assert [c.launches for c in counters] == before
    meta = torch.device('meta')
    m = {k: v.to(meta) for k, v in dict(
        b=torch.zeros(1, 8, 4), s=torch.zeros(1, 8),
        l=torch.zeros(1, 8, dtype=torch.long),
        v=torch.zeros(1, 8, dtype=torch.bool)).items()}
    with pytest.raises(RuntimeError, match='no kernel'):
        matrix_nms(m['b'], m['s'], m['l'])
    with pytest.raises(RuntimeError, match='no kernel'):
        matrix_decay(m['s'], torch.zeros(1, 8, 8, device=meta), m['l'])
    with pytest.raises(RuntimeError, match='no kernel'):
        fast_nms_keep(m['b'], m['l'], m['v'], m['l'], 0.5)
    with pytest.raises(RuntimeError, match='no kernel'):
        nms_match_leader(m['b'], m['s'], m['v'], m['v'], 0.5)
    with pytest.raises(RuntimeError, match='no kernel'):
        masked_conv2d(torch.zeros(1, 3, 6, 6, device=meta),
                      torch.ones(1, 6, 6, device=meta),
                      torch.zeros(4, 3, 3, 3, device=meta))
    assert [c.launches for c in counters] == before

