"""Port parity of fast NMS and nms_match (rows 12c and 12d of PERF.md) on
the edge cases of their kernels' rules, against erd_tpu on the CPU.

The kernels (csrc/extra_nms.cu ``erd_fast_nms``, csrc/nms.cu
``erd_nms_match_leader``) compute the stable descending order from the
scores themselves and read nms_match's leaders from row 1's suppression
words; their plain versions, which the CPU runs, must agree with erd_tpu
where those rules are thin: NaN, +inf, -inf and signed-zero scores, with
and without ``valid_mask``; one class, and int64 labels that are large or
negative; zero-area boxes and thresholds >= 1 (kept boxes then lead no
one, not even themselves); a NaN-scored box whose leader comes later in
row 1's order; K = 1, K not a multiple of 32 or 64, and a batch of two.
tests/test_torch_cuda.py holds the kernels to these plain versions on the
same cases.

Tolerance: exact (keep masks and leaders are integers; the IoUs are
rounded op for op as erd_tpu's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.ops import extra_nms as j_extra
from erd_tpu_torch.ops import fast_nms, nms_match

torch.set_num_threads(2)

SPECIAL = np.float32([np.nan, np.inf, -np.inf, -0.0, 0.0])
WIDE_LABELS = np.int64([2 ** 40 + 3, -7, -2 ** 62, 5, 2 ** 40 + 1027])


def edge_case(seed, k, labels='few'):
    """(boxes, scores, labels, valid) of one image: boxes around two centres
    on a 1/4-pixel grid with exact duplicates and zero-area boxes, scores on
    a 1/8 grid (ties) of which ~30 % are NaN, +inf, -inf, -0 or +0, ~15 %
    invalid; labels from 3 classes, one class, or the int64 values of
    ``WIDE_LABELS`` (large, negative; equal modulo 1024 in pairs)."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(30, 60, (2, 2))[rs.randint(2, size=k)] + \
        rs.normal(0, 6, (k, 2))
    wh = rs.uniform(4, 30, (k, 2))
    boxes = np.round(np.concatenate([c - wh / 2, c + wh / 2], -1) * 4) / 4
    dup = rs.rand(k) < 0.15
    boxes[dup] = boxes[rs.randint(k, size=int(dup.sum()))]
    flat = rs.rand(k) < 0.08
    boxes[flat, 2] = boxes[flat, 0]
    scores = (rs.randint(0, 8, k) / 8).astype(np.float32)
    odd = rs.rand(k) < 0.3
    scores[odd] = SPECIAL[rs.randint(len(SPECIAL), size=int(odd.sum()))]
    lab = {'few': rs.randint(0, 3, k), 'one': np.zeros(k, np.int64),
           'wide': WIDE_LABELS[rs.randint(len(WIDE_LABELS), size=k)]}[labels]
    return (boxes.astype(np.float32), scores, lab.astype(np.int64),
            rs.rand(k) > 0.15)


def t(a):
    return torch.from_numpy(np.asarray(a))


def j_fast(boxes, scores, labels, thr, valid):
    return np.asarray(j_extra.fast_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), thr,
        None if valid is None else jnp.asarray(valid)))


def j_match(boxes, scores, thr, valid):
    keep, leader = j_extra.nms_match(
        jnp.asarray(boxes), jnp.asarray(scores), thr,
        None if valid is None else jnp.asarray(valid))
    return np.asarray(keep), np.asarray(leader)


CASES = [(0, 37, 'few', 0.5), (1, 37, 'one', 0.5), (2, 37, 'wide', 0.5),
         (3, 37, 'few', 1.0), (4, 100, 'one', 0.3), (5, 100, 'few', 1.5),
         (6, 1, 'few', 0.5), (7, 100, 'wide', 0.3)]


@pytest.mark.parametrize('seed,k,labels,thr', CASES)
@pytest.mark.parametrize('masked', [False, True])
def test_fast_nms_matches_erd_tpu_on_edge_cases(seed, k, labels, thr,
                                                masked):
    boxes, scores, lab, valid = edge_case(seed, k, labels)
    valid = valid if masked else None
    want = j_fast(boxes, scores, lab, thr, valid)
    got = fast_nms(t(boxes), t(scores), t(lab), thr,
                   None if valid is None else t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    live = (valid if masked else True) & (scores == scores) & (
        scores > -np.inf)
    assert not want[~live].any()  # NaN, -inf and invalid never kept


@pytest.mark.parametrize('seed,k,labels,thr', CASES)
@pytest.mark.parametrize('masked', [False, True])
def test_nms_match_matches_erd_tpu_on_edge_cases(seed, k, labels, thr,
                                                 masked):
    boxes, scores, _, valid = edge_case(seed, k, labels)
    valid = valid if masked else None
    jk, jl = j_match(boxes, scores, thr, valid)
    keep, leader = nms_match(t(boxes), t(scores), thr,
                             None if valid is None else t(valid))
    np.testing.assert_array_equal(keep.numpy(), jk)
    np.testing.assert_array_equal(leader.numpy(), jl)
    if thr >= 1:  # no IoU exceeds 1: no one leads
        assert (jl == -1).all()


def test_fast_nms_and_nms_match_batch_of_two_match_erd_tpu():
    """A batch of two images (K = 65): each image as erd_tpu gives it."""
    cases = [edge_case(10 + i, 65, labels) for i, labels in
             enumerate(['few', 'wide'])]
    boxes, scores, lab, valid = (np.stack(a) for a in zip(*cases))
    got = fast_nms(t(boxes), t(scores), t(lab), 0.5, t(valid))
    keep, leader = nms_match(t(boxes), t(scores), 0.5, t(valid))
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), j_fast(boxes[i], scores[i], lab[i], 0.5,
                                   valid[i]))
        jk, jl = j_match(boxes[i], scores[i], 0.5, valid[i])
        np.testing.assert_array_equal(keep[i].numpy(), jk)
        np.testing.assert_array_equal(leader[i].numpy(), jl)


def test_nms_match_nan_scored_box_takes_a_later_leader():
    """A valid box scored NaN: row 1's sort puts it first and never keeps
    it, so no suppression word names its leader; erd_tpu gives it the
    highest-scoring kept box that overlaps it, which here comes later in
    row 1's order (and a box scored +inf leads no one: -1)."""
    boxes = np.float32([[0, 0, 10, 10], [1, 1, 11, 11], [0, 1, 10, 11],
                        [50, 50, 60, 60], [51, 50, 61, 60],
                        [100, 100, 110, 110], [101, 101, 111, 111]])
    scores = np.float32([np.nan, 0.5, 0.25, 0.75, np.nan, np.inf, 0.5])
    jk, jl = j_match(boxes, scores, 0.5, None)
    keep, leader = nms_match(t(boxes), t(scores), 0.5)
    np.testing.assert_array_equal(keep.numpy(), jk)
    np.testing.assert_array_equal(leader.numpy(), jl)
    assert leader.tolist() == [1, 1, 1, 3, 3, -1, -1]
