"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import copy
import os

import numpy as np
import pytest
import torch

from erd_tpu_torch.apis import (build_detector, inference_detector,
                                init_detector)
from erd_tpu_torch.config import Config
from erd_tpu_torch.data import DetPipeline, ImageRecord
from erd_tpu_torch.models.heads import arrange_sampling
from erd_tpu_torch.models.heads.gfl_head import AnchorContext, gfl_targets
from erd_tpu_torch.ops import (ModulatedDeformConv, arrange_offsets,
                               carafe, carafe_plain, deform_im2col,
                               deform_im2col_plain, integral_decode,
                               integral_decode_plain,
                               map_roi_levels, ms_deform_attn,
                               ms_deform_attn_plain, multilevel_roi_align,
                               nms_sorted_keep,
                               nms_sorted_keep_plain, roi_align,
                               roi_align_plain, set_nms_sorted_keep,
                               set_nms_sorted_keep_plain, soft_nms,
                               soft_nms_plain)
from erd_tpu_torch.ops.erd_distill import erd_distill_plain, \
    fused_erd_distill
from erd_tpu_torch.ops.ers_select import ers_select, ers_select_plain, \
    ers_threshold
from erd_tpu_torch.ops.gfl_loss import fused_gfl_loss, gfl_loss_plain
from erd_tpu_torch.ops.misc import take_rows
from erd_tpu_torch.structures import GTInstances, stack_to
from erd_tpu_torch.task import atss_assign, atss_assign_plain, valid_flags
from erd_tpu_torch.utils import conv_fp32_precision

pytestmark = pytest.mark.cuda

ERD_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'configs/gfl_increment/gfl_r50_fpn_1x_coco_first_40_incre_last_40_cats.py')
VFNET_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'configs/vfnet/vfnet_r50_mdconv_c3_c5_fpn_ms2x_coco.py')


@pytest.fixture
def cuda():
    """The card, in torch's default precision settings: the port sets the
    precision of its own float32 convolutions."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def sorted_nms_case(rs, b, k, num_labels=80):
    """Clustered boxes over many labels, invalid entries, tied scores;
    sorted and class-shifted as ``nms_mask`` hands them to the kernel."""
    boxes, valid, order = [], [], []
    for _ in range(b):
        centres = rs.uniform(50, 1300, (6, 2))
        c = centres[rs.randint(6, size=k)] + rs.normal(0, 10, (k, 2))
        wh = rs.uniform(16, 120, (k, 2))
        bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        labels = rs.randint(0, num_labels, k)
        scores = (rs.randint(0, 50, k) / 50).astype(np.float32)
        v = rs.rand(k) > 0.1
        bx = bx + (labels * (bx.max() + 1)).astype(np.float32)[:, None]
        s = np.where(v, scores, -np.inf)
        o = np.argsort(-s, kind='stable')
        boxes.append(bx[o])
        valid.append(s[o] > -np.inf)
        order.append(o)
    return (torch.from_numpy(np.stack(boxes)), torch.from_numpy(
        np.stack(valid)), torch.from_numpy(np.stack(order)))


def rpn_nms_case(rs, b, k, canvas=(800, 1344), kind='random'):
    """Proposals as the RPN's training call hands them to the kernel: five
    levels (2000 a level, the rest on the last), boxes of the level's scale
    around 60 centres, clipped to the canvas, shifted apart by level as
    ``batched_nms_mask`` does, tied scores, 10 % invalid, sorted. ``kind``
    'invalid' makes every entry invalid; 'same' makes every box the first,
    unshifted (every pair suppresses), and every entry valid."""
    h, w = canvas
    level = np.minimum(np.arange(k) // 2000, 4)
    boxes, valid, order = [], [], []
    for _ in range(b):
        size = 32.0 * 2.0 ** level[:, None] * rs.uniform(0.5, 2.0, (k, 2))
        c = rs.uniform(0, 1, (60, 2))[rs.randint(60, size=k)] * [w, h] + \
            rs.normal(0, 1, (k, 2)) * size / 4
        bx = np.concatenate([c - size / 2, c + size / 2], -1)
        bx = np.clip(bx, 0, [w, h, w, h]).astype(np.float32)
        v = rs.rand(k) > 0.1
        if kind == 'same':
            bx[:] = bx[0]
            v[:] = True
        else:
            v &= kind != 'invalid'
            bx = bx + (level * (bx.max() + 1)).astype(np.float32)[:, None]
        s = np.where(v, rs.randint(0, 200, k) / 200, -np.inf)
        o = np.argsort(-s, kind='stable')
        boxes.append(bx[o])
        valid.append(s[o] > -np.inf)
        order.append(o)
    return (torch.from_numpy(np.stack(boxes)), torch.from_numpy(
        np.stack(valid)), torch.from_numpy(np.stack(order)))


@pytest.mark.parametrize('k,thr', [(2000, 0.6), (4481, 0.005), (70, 0.5),
                                   (8819, 0.7), (1, 0.5), (63, 0.5),
                                   (64, 0.5), (65, 0.5)])
def test_nms_kernel_matches_plain(cuda, k, thr):
    """K = 8819 is the RPN's training call (16 images, five levels, boxes
    clipped to an 800x1344 canvas); K = 1 and 63-65 sit at and around one
    64-box tile."""
    if k == 8819:
        sboxes, svalid, order = rpn_nms_case(np.random.RandomState(k), 16,
                                             k)
    else:
        sboxes, svalid, order = sorted_nms_case(np.random.RandomState(k), 2,
                                                k)
    args = [t.to(cuda) for t in (sboxes, svalid, order)]
    before = nms_sorted_keep.launches
    got = nms_sorted_keep(*args, thr)
    torch.cuda.synchronize()
    assert nms_sorted_keep.launches == before + 1
    want = nms_sorted_keep_plain(*args, thr)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), nms_sorted_keep(sboxes, svalid, order,
                                                  thr))


@pytest.mark.parametrize('kind', ['invalid', 'same'])
@pytest.mark.parametrize('b,k', [(2, 1), (2, 63), (2, 64), (2, 65),
                                 (1, 2000), (16, 8819)])
def test_nms_kernel_matches_plain_on_empty_and_dense_batches(cuda, kind, b,
                                                             k):
    """An all-invalid batch keeps nothing; a batch of one box repeated
    (every pair suppresses, every mask word right of the diagonal set)
    keeps one box an image: both equal to plain."""
    sboxes, svalid, order = rpn_nms_case(np.random.RandomState(k), b, k,
                                         kind=kind)
    args = [t.to(cuda) for t in (sboxes, svalid, order)]
    got = nms_sorted_keep(*args, 0.7)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_sorted_keep_plain(*args, 0.7))
    assert int(got.sum()) == (0 if kind == 'invalid' else b)


def test_integral_decode_kernel_matches_plain(cuda):
    rs = np.random.RandomState(0)
    ctx = AnchorContext.build((800, 1344))
    centers, strides = ctx.device_tensors(cuda)
    n = ctx.num_anchors
    reg = torch.from_numpy((rs.randn(2, n, 68) * 3).astype(np.float32))
    rows = torch.from_numpy(rs.randint(0, n, (2, 5000)))
    img_shape = torch.tensor([[800.0, 1333.0], [750.0, 1000.0]])
    args = [reg.to(cuda), rows.to(cuda), centers, strides,
            img_shape.to(cuda)]
    got = integral_decode(*args)
    torch.cuda.synchronize()
    want = integral_decode_plain(*args)
    stride = strides[args[1]].unsqueeze(-1)
    assert torch.all((got - want).abs() <= 1e-4 * stride +
                     1e-5 * want.abs())


def test_serving_on_cuda_uses_kernels_and_matches_cpu(cuda):
    """bf16 ResNet-18 ERD detector on the card; the same head outputs
    post-processed on the card (kernels) and on the CPU (plain versions)
    give the same detections."""
    cfg = Config.fromfile(ERD_CFG)
    cfg.model.depth = 18
    det, net, _ = init_detector(cfg, device=cuda)
    with torch.no_grad():
        net.bbox_head.gfl_cls.bias.zero_()
    img = np.random.RandomState(1).randint(0, 256, (128, 192, 3), np.uint8)
    nms_before = nms_sorted_keep.launches
    dec_before = integral_decode.launches
    res = inference_detector(det, net, img, scale=(192, 128))
    assert nms_sorted_keep.launches == nms_before + 1
    assert integral_decode.launches == dec_before + 1
    assert 10 < len(res.scores) <= 100

    rec = ImageRecord(0, '', 192, 128, np.zeros((0, 4), np.float32),
                      np.zeros((0,), np.int32), np.zeros((0,), bool))
    canvas, _, meta = DetPipeline(scale=(192, 128))(rec, image=img)
    images = torch.from_numpy(canvas[None]).to(cuda)
    ctx = det.anchor_context(images.shape[1:3])
    cls, reg = det.forward_raw(net, images)
    got = det.postprocess(ctx, cls, reg, stack_to([meta], cuda))
    want = det.postprocess(ctx, [c.cpu() for c in cls],
                           [r.cpu() for r in reg], stack_to([meta], 'cpu'))
    assert torch.equal(got.mask.cpu(), want.mask)
    assert torch.equal(got.labels.cpu(), want.labels)
    torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(got.bboxes.cpu(), want.bboxes, rtol=0,
                               atol=1e-3)


TRAIN_SHAPE = (800, 1344)


def train_gt(rs, b, g_max=16):
    """1-12 random gt boxes per image in 16 padded slots, 40 labels."""
    boxes = np.zeros((b, g_max, 4), np.float32)
    labels = np.zeros((b, g_max), np.int64)
    mask = np.zeros((b, g_max), bool)
    for i in range(b):
        g = rs.randint(1, 13)
        xy = rs.uniform(0, 1100, (g, 2))
        wh = rs.uniform(16, 500, (g, 2))
        boxes[i, :g] = np.concatenate(
            [xy, np.minimum(xy + wh, [1333, 800])], -1)
        labels[i, :g] = rs.randint(0, 40, g)
        mask[i, :g] = True
    return GTInstances(bboxes=torch.from_numpy(boxes),
                       labels=torch.from_numpy(labels),
                       mask=torch.from_numpy(mask))


def to(gt, device):
    return GTInstances(bboxes=gt.bboxes.to(device),
                       labels=gt.labels.to(device), mask=gt.mask.to(device))


def atss_case(name, cuda):
    """(args, topk) of an ATSS call: the 800x1344 canvas (or a 128x128 one
    whose P6 and P7 hold fewer anchors than topk) with 16 gt slots."""
    rs = np.random.RandomState(0)
    shape = (128, 128) if name == 'small_level' else TRAIN_SHAPE
    ctx = AnchorContext.build(shape)
    b = {'step': 16, 'many_gts': 1}.get(name, 2)
    gt = train_gt(rs, b)
    if name == 'many_gts':
        gt = train_gt(rs, b, g_max=100)
        gt.mask[:] = True
        xy = rs.uniform(0, [1300, 780], (100, 2))
        wh = rs.uniform(16, 400, (100, 2))
        gt.bboxes[0] = torch.from_numpy(np.concatenate(
            [xy, np.minimum(xy + wh, [1333, 800])], -1).astype(np.float32))
    if name == 'ties':
        # centres on anchor centres and on the midpoints between them: the
        # level's distances tie in groups of 2, 4 and 8, across slot topk
        for i in range(b):
            for j in range(12):
                step = (8, 16, 32)[j % 3]
                cx = step * rs.randint(4, 40) + (step // 2) * (j % 2)
                cy = step * rs.randint(4, 24) + (step // 2) * (j // 2 % 2)
                half = rs.uniform(20, 100, 2)
                gt.bboxes[i, j] = torch.tensor(
                    [cx - half[0], cy - half[1], cx + half[0], cy + half[1]])
            gt.mask[i, :12] = True
    if name == 'small_level':
        gt.bboxes = gt.bboxes * 0.1
    if name == 'no_gt':
        gt.mask[:] = False
    gt = to(gt, cuda)
    pad = torch.tensor([list(map(float, shape))] * b, device=cuda)
    if name not in ('small_level', 'many_gts', 'step'):
        pad[1] = torch.tensor([768.0, 1024.0])
    vf = valid_flags(ctx.featmap_sizes, ctx.strides, pad)
    if name == 'invalid_level':
        lo = ctx.num_level_anchors[0]
        vf[0, lo:lo + ctx.num_level_anchors[1]] = False
    topk = {'topk1': 1, 'topk32': 32}.get(name, 9)
    return (ctx.device_anchors(cuda), ctx.num_level_anchors, gt.bboxes,
            gt.labels, gt.mask, vf), topk


def ties_across_slot(args, topk):
    """Whether some (image, real gt, level) has equal distances at the
    topk-th and the next slot (plain float32 arithmetic)."""
    anchors, nla, gtb, _, gtm, vf = args
    ac = (anchors[:, :2] + anchors[:, 2:]) / 2
    gc = (gtb[..., :2] + gtb[..., 2:]) / 2
    d = (ac[None, :, None] - gc[:, None]).square().sum(-1).sqrt()
    d = torch.where(vf[..., None], d, torch.full_like(d, 1e8))
    start = 0
    for size in nla:
        if size > topk:
            lvl = d[:, start:start + size].sort(1).values
            tie = (lvl[:, topk - 1] == lvl[:, topk]) & gtm
            if bool(tie.any()):
                return True
        start += size
    return False


@pytest.mark.parametrize('name', [
    'two', 'step', 'many_gts', 'ties', 'invalid_level', 'small_level',
    'topk1', 'topk32', 'no_gt'])
def test_atss_kernel_matches_plain(cuda, name):
    """All four outputs exactly as plain: two images (the second padded
    to 768x1024), a bs-16 step at N = 22400, 100 gts in an image, gt
    centres on anchor centres and midpoints (equal distances across the
    topk-th slot), a level wholly invalid, levels smaller than topk, topk
    1 and 32, no real gt."""
    args, topk = atss_case(name, cuda)
    before = atss_assign.launches
    got = atss_assign(*args, topk=topk)
    torch.cuda.synchronize()
    assert atss_assign.launches == before + 1
    want = atss_assign_plain(*args, topk=topk)
    assert (got.pos_mask.sum() > 0) == (name != 'no_gt')
    if name == 'ties':
        assert ties_across_slot(args, topk)
    if name == 'small_level':
        assert min(args[1]) < topk
    for field in ('pos_mask', 'gt_idx', 'labels', 'max_overlaps'):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def bf16_tensor(a, cuda):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        cuda).bfloat16().float()


def ers_threshold_case(b):
    """N = 513 rows whose criteria sit exactly on their thresholds: 64
    rows at c = 1 (logit 30) and r = 2, as many at c = 0 (logit -inf) and
    r = -2, the rest at c = 1/2 (logit 0) and r = 0, each +/- pair inside
    one 256-row block. Every sum is exact in float32 whatever its order,
    and mean + 2 * std is 1 (cls) and 2 (reg) exactly: N - 1 = 8 * 64."""
    n, cls, reg = 513, np.zeros((513,), np.float32), np.zeros((513,))
    for base in (0, 256):
        for k in range(32):
            cls[base + 2 * k], reg[base + 2 * k] = 30.0, 2.0
            cls[base + 2 * k + 1], reg[base + 2 * k + 1] = -np.inf, -2.0
    t_cls = np.broadcast_to(cls[None, :, None], (b, n, 40))
    t_reg = np.broadcast_to(reg[None, :, None], (b, n, 68))
    return t_cls, t_reg


def ers_case(name, cuda):
    """(t_cls, t_reg, cap) of one ERS kernel case: bf16-valued teacher
    outputs at the train canvas (N = 22400), B = 2 unless named."""
    rs = np.random.RandomState(1)
    b, n = 2, AnchorContext.build(TRAIN_SHAPE).num_anchors
    b = {'step16': 16, 'b1': 1, 'ragged': 3}.get(name, b)
    n = {'ragged': 1001, 'large_n': 45000}.get(name, n)
    c_cls, c_reg = (5, 34) if name == 'odd_width' else (40, 68)
    t_cls = rs.randn(b, n, c_cls) * 2 - 4
    t_reg = rs.randn(b, n, c_reg) * 2
    cap = {'cap1': 1, 'capN': n}.get(name, n // 5 + 1)
    if name == 'step16':  # as chip_smoke.train_case makes them
        t_cls = rs.randn(b, n, c_cls) * 1.5 - 4
        hot = rs.rand(b, n) < 0.01
        t_cls = np.where(hot[..., None], t_cls + 6, t_cls)
        t_reg = np.where(hot[..., None], t_reg + 3, t_reg)
    if name == 'grid8':  # thousands tie at the cap boundary
        t_reg = np.round(t_reg * 8) / 8
    if name == 'tie_run':  # a few levels: long runs across the cap-th slot
        t_reg = np.round(t_reg * 2) / 2
    if name == 'all_equal':
        t_cls = np.full_like(t_cls, -2.0)
        t_reg = np.full_like(t_reg, 1.5)
    if name == 'at_threshold':
        t_cls, t_reg = ers_threshold_case(b)
        cap = t_cls.shape[1] // 5 + 1
    if name == 'signed_zero':
        # every bin <= -1 but one: -0 in 85 % of the rows, +0 in 5 %, a
        # positive value in the rest; the cap-th slot falls among the -0s
        t_reg = -np.abs(t_reg) - 1
        pick = rs.rand(b, n)
        col = rs.randint(0, c_reg, (b, n))
        val = np.where(pick < 0.85, -0.0, np.where(pick < 0.9, 0.0,
                                                     rs.rand(b, n) + 1))
        np.put_along_axis(t_reg, col[..., None], val[..., None], -1)
    return bf16_tensor(t_cls, cuda), bf16_tensor(t_reg, cuda), cap


@pytest.mark.parametrize('name', [
    'bf16', 'grid8', 'step16', 'all_equal', 'tie_run', 'cap1', 'cap4481',
    'capN', 'ragged', 'large_n', 'odd_width', 'b1', 'at_threshold',
    'signed_zero'])
def test_ers_select_kernel_matches_plain(cuda, name):
    """Lists exactly; a mask entry may differ only where its criterion lies
    within 1e-6 * |thr| of the threshold (sums in another order); the
    count is the mask's sum. bf16 criteria (B = 2 at the train canvas), on
    a grid of 1/8 (thousands tie at the cap boundary), a bs-16 step's,
    every criterion equal (the list is rows 0 ... cap - 1), a tie run
    across the cap-th slot, cap 1, 4481 and N, N = 1001 (not a multiple
    of 32), N = 45000 (more keys than the select stages in shared
    memory), widths 5 and 34 (single loads), B = 1, criteria exactly on
    the thresholds (strict >), -0 and +0 among the maxima (+0 first)."""
    t_cls, t_reg, cap = ers_case(name, cuda)
    before = ers_select.launches
    got = ers_select(t_cls, t_reg, cap)
    torch.cuda.synchronize()
    assert ers_select.launches == before + 1
    want = ers_select_plain(t_cls, t_reg, cap)
    assert torch.equal(got[1], want[1])
    crits = (torch.sigmoid(t_cls).amax(-1), t_reg.amax(-1))
    for g, w, crit, near_idx in ((got[0], want[0], crits[0], None),
                                 (got[2], want[2], crits[1], want[1])):
        thr = ers_threshold(crit)[:, None]
        c = crit if near_idx is None else torch.gather(crit, 1, near_idx)
        near = (c - thr).abs() <= 1e-6 * thr.abs()
        assert torch.equal(g & ~near, w & ~near)
    assert (got[3].long() == got[2].sum(-1)).all()
    b, n = t_cls.shape[:2]
    if name == 'all_equal':
        assert (got[1] == torch.arange(cap, device=cuda)).all()
        assert not got[0].any() and not got[2].any()
    elif name == 'at_threshold':
        # exactly on the threshold is not above it, and both sides agree
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert (ers_threshold(crits[0]) == 1.0).all()
        assert (ers_threshold(crits[1]) == 2.0).all()
        assert (crits[1] == 2.0).any() and not got[0].any()
        assert not got[2].any()
    else:
        assert 0 < int(got[3].max())
    if name in ('tie_run', 'grid8'):
        vals = torch.sort(crits[1], dim=1, descending=True)[0]
        assert bool((vals[:, cap - 1] == vals[:, cap]).all())
    if name == 'signed_zero':
        picked = torch.gather(crits[1], 1, got[1])
        zero = picked == 0
        # +0 rows come before every -0 row of the list
        neg = torch.signbit(picked) & zero
        pos = ~torch.signbit(picked) & zero
        assert bool(neg.any(1).all()) and bool(pos.any(1).all())
        first_neg = torch.where(neg.any(1), neg.float().argmax(1), cap)
        last_pos = cap - 1 - pos.flip(1).float().argmax(1)
        assert bool((last_pos < first_neg).all())


def test_decode_kernel_without_clip(cuda):
    rs = np.random.RandomState(2)
    ctx = AnchorContext.build(TRAIN_SHAPE)
    centers, _ = ctx.device_tensors(cuda)
    n = ctx.num_anchors
    reg = torch.from_numpy((rs.randn(2, n, 68) * 3).astype(
        np.float32)).to(cuda)
    rows = torch.from_numpy(rs.randint(0, n, (2, 4481))).to(cuda)
    unit = torch.ones(n, device=cuda)
    got = integral_decode(reg, rows, centers, unit, None)
    torch.cuda.synchronize()
    want = integral_decode_plain(reg, rows, centers, unit, None)
    assert (want < 0).any()  # nothing was clipped
    assert torch.all((got - want).abs() <= 1e-4 + 1e-5 * want.abs())


def gfl_case(rs, cuda, b=2):
    ctx = AnchorContext.build(TRAIN_SHAPE)
    n = ctx.num_anchors
    gt = to(train_gt(rs, b), cuda)
    shapes = torch.tensor([[800.0, 1333.0], [750.0, 1000.0]],
                          device=cuda)[:b]
    t = gfl_targets(ctx, gt, shapes, 40)
    cls = torch.from_numpy((rs.randn(b, n, 80) * 2 - 2).astype(
        np.float32)).to(cuda)
    reg = torch.from_numpy((rs.randn(b, n, 68) * 2).astype(
        np.float32)).to(cuda)
    centers, strides = ctx.device_tensors(cuda)
    return (cls, reg, t.labels, t.label_weights, t.bbox_targets, t.pos_mask,
            t.num_pos, centers, strides)


def gfl_loss_case(name, cuda):
    """(wide class map, first column, C, the loss's other arguments,
    keywords): synthetic rows with ~2 % positives, their targets around
    their anchor centres, strides of the five levels."""
    rs = np.random.RandomState(5)
    b, n, width, lo, c = 2, 22400, 80, 40, 40
    if name == 'full80':
        lo, c = 0, 80
    if name == 'c1':
        lo, c = 7, 1
    if name == 'ragged':
        b, n = 3, 1001  # 3003 rows: not a multiple of 8 or 64
    stride = rs.choice([8.0, 16.0, 32.0, 64.0, 128.0], n).astype(np.float32)
    ctr = rs.uniform(0, 1300, (n, 2)).astype(np.float32)
    pos = rs.rand(b, n) < (0.0 if name == 'no_positive' else 0.02)
    reg = (rs.randn(b, n, 68) * 2).astype(np.float32)
    dist = rs.uniform(0.5, 18.0, (b, n, 4)).astype(np.float32)
    if name == 'edges':
        # side distances on exact bins and past the reg_max - 0.1 clamp
        dist = rs.randint(0, 21, (b, n, 4)).astype(np.float32)
    if name == 'ties':
        # two-hot distributions at bins 2 and 4: each corner is exactly 3,
        # and the targets' sides are exactly the predicted ones
        reg = np.full((b, n, 4, 17), -200.0, np.float32)
        reg[..., 2] = reg[..., 4] = 0.0
        reg = reg.reshape(b, n, 68)
        dist = np.full((b, n, 4), 3.0, np.float32)
        dist[:, 1::2, 2:] = 5.0  # half the rows tie on two sides only
    sides = dist * stride[None, :, None]
    bt = np.concatenate([ctr[None] - sides[..., :2],
                         ctr[None] + sides[..., 2:]], -1).astype(np.float32)
    labels = np.where(pos, rs.randint(0, c, (b, n)), c)
    lw = (rs.rand(b, n) > 0.05).astype(np.float32)
    wide = (rs.randn(b, n, width) * 2 - 2).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    kw = {'qfl_beta': 1.5} if name == 'beta1.5' else {}
    num_pos = torch.tensor(float(pos.sum()), device=cuda)
    return (t(wide), lo, c, (t(reg), t(labels), t(lw), t(bt), t(pos),
                             num_pos, t(ctr), t(stride)), kw)


@pytest.mark.parametrize('name', [
    'slice40', 'full80', 'c1', 'ragged', 'beta1.5', 'edges', 'ties',
    'no_positive', 'step'])
def test_gfl_loss_kernel_matches_plain(cuda, name):
    """Values rtol 1e-4, gradients within 1e-4 relative + 1e-5 * max|g|
    (float32; partial sums in another order), the class map's other
    columns' gradient exactly 0, two kernel calls bit-equal: C = 40 as a
    slice of 80, C = 80 and C = 1; 3003 rows; qfl_beta 1.5; DFL targets on
    exact bins and past the clamp; predicted and target sides exactly
    equal (max / min ties split 1/2 : 1/2); no positive; the ERD targets
    of two 800x1344 images (``step``)."""
    if name == 'step':
        args = gfl_case(np.random.RandomState(3), cuda)
        wide, lo, c, rest, kw = args[0], 40, 40, args[1:], {}
    else:
        wide, lo, c, rest, kw = gfl_loss_case(name, cuda)
    outs, grads = [], []
    for fn in (fused_gfl_loss, fused_gfl_loss, gfl_loss_plain):
        cls = wide.clone().requires_grad_(True)
        reg = rest[0].clone().requires_grad_(True)
        losses = fn(cls[..., lo:lo + c], reg, *rest[1:], **kw)
        sum(losses).backward()
        outs.append(torch.stack(losses).detach())
        grads.append((cls.grad, reg.grad))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(grads[0], grads[1]))
    torch.testing.assert_close(outs[0], outs[2], rtol=1e-4, atol=0)
    for g, w in zip(grads[0], grads[2]):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))
    other = torch.ones(wide.shape[-1], dtype=torch.bool, device=cuda)
    other[lo:lo + c] = False
    assert not grads[0][0][..., other].any()
    if name == 'no_positive':
        assert float(outs[0][1]) == float(outs[0][2]) == 0.0
        assert grads[0][1].abs().max() == 0


def distill_case(name, cuda):
    """(leaf, s_cls view of it, s_reg, t_cls, t_reg, cls_mask, kept, C,
    keywords) of one distillation kernel case: B = 2 at the train canvas,
    C = 40 of an 80-wide map, ~3 % ERS-cls and ~2 % kept rows, T = 10,
    unless named."""
    rs = np.random.RandomState(4)
    b, n, w, c = 2, AnchorContext.build(TRAIN_SHAPE).num_anchors, 80, 40
    b = {'step16': 16, 'ragged': 3}.get(name, b)
    n = 1001 if name == 'ragged' else n
    w, c = {'c80': (80, 80), 'c_odd': (7, 5), 'strided': (88, 40)}.get(
        name, (w, c))
    leaf = rs.randn(b, n, w).astype(np.float32)
    s_reg = (rs.randn(b, n, 68) * 2).astype(np.float32)
    t_cls = (rs.randn(b, n, c) - 3).astype(np.float32)
    t_reg = (rs.randn(b, n, 68) * 2).astype(np.float32)
    cm = rs.rand(b, n) < 0.03
    kept = rs.rand(b, n) < 0.02
    kw = {'T': 1.0} if name in ('t1', 'underflow') else {}
    if name == 'no_selected':
        cm[1] = kept[1] = False
    if name == 'all_selected':
        cm[:] = kept[:] = True
    if name == 'disjoint':  # kept rows that are not ERS-cls and the reverse
        kept = rs.rand(b, n) < 0.05
        cm = ~kept & (rs.rand(b, n) < 0.05)
    if name == 'underflow':
        # each side one teacher bin at 0, the others at -200: at T = 1 their
        # softmax underflows to exactly 0
        t_reg = np.full((b, n, 4, 17), -200.0, np.float32)
        np.put_along_axis(t_reg, rs.randint(0, 17, (b, n, 4, 1)), 0.0, -1)
        t_reg = t_reg.reshape(b, n, 68)
        kept = rs.rand(b, n) < 0.2
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    leaf = t(leaf)
    width = 80 if name == 'strided' else w
    return (leaf, width, t(s_reg), t(t_cls), t(t_reg), t(cm), t(kept), c,
            kw)


@pytest.mark.parametrize('name', [
    'two', 'step16', 'no_selected', 'all_selected', 'disjoint', 'c80',
    'c_odd', 'ragged', 't1', 'underflow', 'strided'])
def test_erd_distill_kernel_matches_plain(cuda, name):
    """Per-image values rtol 1e-4, gradients within 1e-4 relative +
    1e-5 * max|g|, the gradient past column C exactly 0, two kernel calls
    bit-equal, one forward and one backward launch a call: C = 40 of 80
    (``two``), a bs-16 batch, an image with no selected row (its l_cls and
    gradient 0), every row selected, kept rows that are not ERS-cls and the
    reverse, C = 80 of 80, C = 5 of 7 (single loads), N = 1001 (not a
    multiple of 8), T = 1 (and the default 10), teacher bins whose softmax
    underflows to exactly 0 (0 * log 0), s_cls a row-strided view (the
    first 80 columns of an 88-wide map)."""
    leaf0, width, s_reg, t_cls, t_reg, cm, kept, c, kw = distill_case(
        name, cuda)
    outs, grads = [], []
    for fn in (fused_erd_distill, fused_erd_distill, erd_distill_plain):
        leaf = leaf0.clone().requires_grad_(True)
        sr = s_reg.clone().requires_grad_(True)
        before = fused_erd_distill.launches
        l_cls, l_reg = fn(leaf[..., :width], sr, t_cls, t_reg, cm, kept,
                          **kw)
        (l_cls.sum() + 3 * l_reg.sum()).backward()
        if fn is fused_erd_distill:
            assert fused_erd_distill.launches == before + 2
        outs.append(torch.stack([l_cls, l_reg]).detach())
        grads.append((leaf.grad, sr.grad))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(grads[0], grads[1]))
    torch.testing.assert_close(outs[0], outs[2], rtol=1e-4, atol=0)
    for g, w in zip(grads[0], grads[2]):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))
    assert not grads[0][0][..., c:].any()
    assert bool((outs[0] > 0).any())
    if name == 'no_selected':
        assert float(outs[0][0, 1]) == float(outs[0][1, 1]) == 0.0
        assert not grads[0][0][1].any() and not grads[0][1][1].any()


FRCNN_SOFT_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'configs/faster_rcnn/faster_rcnn_r50_fpn_soft_nms_1x_coco.py')
ROI_LEVELS = [(200, 336), (100, 168), (50, 84), (25, 42)]  # P2-P5, 800x1344


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_roi_align_kernel_matches_plain(cuda, dtype):
    """1000 RoIs on full-width P2-P5 maps, with off-image, degenerate and
    last-row/column boxes: within 1e-6 * max|feat| (the same arithmetic,
    each op rounded alike)."""
    rs = np.random.RandomState(5)
    feats = [torch.from_numpy(rs.randn(1, 256, h, w).astype(
        np.float32)).to(cuda).to(dtype) for h, w in ROI_LEVELS]
    xy = rs.uniform(-30, [1344, 800], (1000, 2))
    wh = np.exp(rs.uniform(np.log(2), np.log(900), (1000, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:5] = [[0, 0, 0, 0], [1300, 760, 1344, 800], [-60, -40, -2, -1],
                [10, 10, 10, 10], [0, 792, 1344, 800]]
    rois = torch.from_numpy(rois)[None].to(cuda)
    levels = map_roi_levels(rois, 4)
    assert len(torch.unique(levels)) == 4
    before = roi_align.launches
    got = roi_align(feats, rois, levels)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    want = roi_align_plain(feats, rois, levels, (4, 8, 16, 32))
    limit = 1e-6 * max(float(f.float().abs().max()) for f in feats)
    assert float((got - want).abs().max()) <= limit


def soft_nms_case_cuda(rs, cuda, b=2, k=2000):
    boxes, scores = [], []
    for _ in range(b):
        c = rs.uniform(50, 1300, (8, 2))[rs.randint(8, size=k)] + \
            rs.normal(0, 15, (k, 2))
        wh = rs.uniform(16, 120, (k, 2))
        bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        labels = rs.randint(0, 80, k)
        boxes.append(bx + (labels * (bx.max() + 1)).astype(
            np.float32)[:, None])
        s = rs.uniform(0.05, 1, k).astype(np.float32)
        s[rs.rand(k) < 0.1] = -np.inf
        scores.append(s)
    return (torch.from_numpy(np.stack(boxes)).to(cuda),
            torch.from_numpy(np.stack(scores)).to(cuda))


@pytest.mark.parametrize('method', ['linear', 'gaussian'])
def test_soft_nms_kernel_matches_plain(cuda, method):
    """K = 2000, 100 steps: linear bit-exact; gaussian selections equal and
    scores within 1e-6 relative (the card's expf in both, summed decays)."""
    boxes, scores = soft_nms_case_cuda(np.random.RandomState(6), cuda)
    before = soft_nms.launches
    got = soft_nms(boxes, scores, 100, 0.5, 0.5, 1e-3, method)
    torch.cuda.synchronize()
    assert soft_nms.launches == before + 1
    want = soft_nms_plain(boxes, scores, 100, 0.5, 0.5, 1e-3, method)
    assert torch.equal(got[0], want[0])
    if method == 'linear':
        assert torch.equal(got[1], want[1])
    else:
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    cpu = soft_nms(boxes.cpu(), scores.cpu(), 100, 0.5, 0.5, 1e-3, method)
    assert torch.equal(cpu[0], want[0].cpu())


def test_faster_rcnn_serving_on_cuda_uses_kernels(cuda):
    """bf16 ResNet-18 Faster R-CNN with soft-NMS on the card: the RoIAlign,
    NMS and soft-NMS kernels launch, and the same head outputs
    post-processed on the card and on the CPU agree."""
    cfg = Config.fromfile(FRCNN_SOFT_CFG)
    cfg.model.depth = 18
    det, net, _ = init_detector(cfg, device=cuda)
    with torch.no_grad():  # spread the class scores: detections, not bg
        w = net.roi_head.bbox_head.fc_cls.weight
        w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(
            0)).to(cuda) * 0.05)
    img = np.random.RandomState(1).randint(0, 256, (256, 320, 3), np.uint8)
    counts = [f.launches for f in (roi_align, nms_sorted_keep, soft_nms)]
    res = inference_detector(det, net, img, scale=(320, 256))
    after = [f.launches for f in (roi_align, nms_sorted_keep, soft_nms)]
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1]
    assert 0 < len(res.scores) <= 100

    rec = ImageRecord(0, '', 320, 256, np.zeros((0, 4), np.float32),
                      np.zeros((0,), np.int32), np.zeros((0,), bool))
    canvas, _, meta = DetPipeline(scale=(320, 256))(rec, image=img)
    images = torch.from_numpy(canvas[None]).to(cuda)
    feats, rpn_cls, rpn_reg = det.feats_and_rpn(net, images)
    meta_gpu = stack_to([meta], cuda)
    ctx = det.anchor_context(images.shape[1:3])
    rois, _, roi_mask = det.proposals(ctx, rpn_cls, rpn_reg, meta_gpu)
    cls, reg = det.roi_forward(net, det.roi_feats(feats, rois))
    got = det.postprocess(cls, reg, rois, roi_mask, meta_gpu)
    want = det.postprocess(cls.cpu(), reg.cpu(), rois.cpu(), roi_mask.cpu(),
                           stack_to([meta], 'cpu'))
    assert torch.equal(got.mask.cpu(), want.mask)
    assert torch.equal(got.labels.cpu(), want.labels)
    torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(got.bboxes.cpu(), want.bboxes, rtol=0,
                               atol=1e-2)


# the DETR levels of an 800x1344 canvas (strides 8-64) and of its portrait
DETR_LEVELS = {'landscape': [(100, 168), (50, 84), (25, 42), (13, 21)],
               'portrait': [(168, 100), (84, 50), (42, 25), (21, 13)]}
DINO_CFG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs/dino/dino-4scale_r50_12e_coco.py')


@pytest.mark.parametrize('canvas,q', [('landscape', 'tokens'),
                                      ('landscape', 900),
                                      ('portrait', 'tokens'),
                                      ('portrait', 300)])
def test_ms_deform_attn_kernel_matches_plain(cuda, canvas, q):
    """The encoder's call (Q = every token, 22323) and the decoder's (900
    or 300 queries) on both canvases, locations reaching 10 % past the map:
    within 1e-6 * max|v| (the same arithmetic, each op rounded alike); bf16
    weights are widened exactly; other dtypes and head widths raise."""
    shapes = DETR_LEVELS[canvas]
    n = sum(h * w for h, w in shapes)
    q = n if q == 'tokens' else q
    rs = np.random.RandomState(q)
    values = torch.from_numpy(rs.randn(1, n, 8, 32).astype(np.float32))
    locs = torch.from_numpy(rs.uniform(-0.1, 1.1, (1, q, 8, 4, 4, 2)).astype(
        np.float32))
    w = torch.from_numpy(rs.rand(1, q, 8, 16).astype(np.float32)).softmax(-1)
    args = [t.to(cuda) for t in (values, locs, w.reshape(1, q, 8, 4, 4))]
    before = ms_deform_attn.launches
    got = ms_deform_attn(args[0], shapes, *args[1:])
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    want = ms_deform_attn_plain(args[0], shapes, *args[1:])
    limit = 1e-6 * float(values.abs().max())
    assert float((got - want).abs().max()) <= limit
    wb = args[2].bfloat16()
    assert float((ms_deform_attn(args[0], shapes, args[1], wb) -
                  ms_deform_attn_plain(args[0], shapes, args[1],
                                       wb.float())).abs().max()) <= limit
    with pytest.raises(TypeError):
        ms_deform_attn(args[0].double(), shapes, *args[1:])
    with pytest.raises(TypeError):
        ms_deform_attn(args[0], shapes, args[1].half(), args[2])
    with pytest.raises(ValueError, match='head_dim'):
        ms_deform_attn(args[0][..., :16].contiguous(), shapes, *args[1:])


def test_dino_serving_on_cuda_uses_kernel(cuda):
    """bf16 ResNet-18 DINO with arranged sampling weights on the card: the
    sampling kernel launches 12 times per request (6 encoder and 6 decoder
    layers); the head (float32 products of bf16 weights) on the card
    agrees with the CPU's within 1e-3 * max|out|, the decoder run from the
    card's query selection on both."""
    cfg = Config.fromfile(DINO_CFG)
    cfg.model.depth = 18
    det, net, _ = init_detector(cfg, device=cuda)
    arrange_sampling(net, seed=0)
    img = np.random.RandomState(1).randint(0, 256, (256, 320, 3), np.uint8)
    before = ms_deform_attn.launches
    res = inference_detector(det, net, img, scale=(320, 256))
    assert ms_deform_attn.launches - before == 12
    assert len(res.scores) == 300 and np.isfinite(res.bboxes).all()

    images = torch.from_numpy(img[None]).to(cuda)
    feats = det.extract_feat(net, images)
    head, head_cpu = net.bbox_head, copy.deepcopy(net.bbox_head).cpu()
    with torch.no_grad():
        memory, shapes = head.encode(feats)
        enc_cls, enc_boxes = head.proposals(memory, shapes)
        idx = head.select(enc_cls)
        got = head.decode(memory, shapes, idx, take_rows(enc_boxes, idx))
        mem_cpu, _ = head_cpu.encode([f.cpu() for f in feats])
        _, boxes_cpu = head_cpu.proposals(mem_cpu, shapes)
        want = head_cpu.decode(mem_cpu, shapes, idx.cpu(),
                               take_rows(boxes_cpu, idx.cpu()))
    for g, w in zip((memory,) + got, (mem_cpu,) + want):
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=1e-3 * float(w.abs().max()))


def dcn_case(rs, cuda, dtype, b, cin, h, w, dg, stride, scale, border):
    """A map, offsets (scaled normal, or aimed exactly at rows / columns
    -1, 0, H-1 and H with ``border``) and masks for deform_im2col."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.from_numpy(rs.randn(b, cin, h, w).astype(np.float32))
    off = rs.randn(b, dg, 9, 2, ho, wo) * scale
    if border:
        ky, kx = np.divmod(np.arange(9), 3)
        oy = np.arange(ho)[:, None] * stride - 1 + ky[:, None, None]
        ox = np.arange(wo)[None, :] * stride - 1 + kx[:, None, None]
        ty = rs.choice([-1, 0, h - 1, h], (b, dg, 9, ho, wo))
        tx = rs.choice([-1, 0, w - 1, w], (b, dg, 9, ho, wo))
        off = np.stack([ty - oy, tx - ox], 3)
    offset = torch.from_numpy(off.reshape(b, -1, ho, wo).astype(np.float32))
    mask = torch.from_numpy(rs.rand(b, dg * 9, ho, wo).astype(np.float32))
    return x.to(cuda).to(dtype), offset.to(cuda), mask.to(cuda)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('dg,stride,use_mask,border', [
    (1, 1, True, False), (1, 2, False, False), (2, 1, False, False),
    (2, 2, True, False), (1, 1, True, True), (2, 2, False, True)])
def test_deform_im2col_kernel_matches_plain(cuda, dtype, dg, stride,
                                            use_mask, border):
    """The kernel against its plain version on a layer4-sized map (Cin 128,
    25 x 42), with fractional or border-exact offsets: within 1e-6 * max|x|
    (the same arithmetic, each op rounded alike: 0.0 expected)."""
    rs = np.random.RandomState(dg * 100 + stride * 10 + int(border))
    x, offset, mask = dcn_case(rs, cuda, dtype, 2, 128, 25, 42, dg, stride,
                               2.5, border)
    mask = mask if use_mask else None
    args = (x, offset, mask, 3, stride, 1, 1, dg)
    before = deform_im2col.launches
    got = deform_im2col(*args)
    torch.cuda.synchronize()
    assert deform_im2col.launches == before + 1
    want = deform_im2col_plain(*args)
    assert got.shape == want.shape == (2, 128 * 9, offset.shape[2] *
                                       offset.shape[3])
    assert float((got - want).abs().max()) <= \
        1e-6 * float(x.float().abs().max())


def test_deform_im2col_never_reaches_plain_on_cuda(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises; the plain version is
    never called for it."""
    import erd_tpu_torch.ops.deform_conv as dcn_module

    def refuse(*args):
        raise AssertionError('the plain version ran on a CUDA tensor')
    monkeypatch.setattr(dcn_module, 'deform_im2col_plain', refuse)
    x, offset, mask = dcn_case(np.random.RandomState(0), cuda,
                               torch.float32, 1, 16, 9, 10, 1, 1, 1.0, False)
    dcn_module.deform_im2col(x, offset, mask, 3, 1, 1, 1, 1)
    with pytest.raises(ValueError, match='contiguous'):
        dcn_module.deform_im2col(x.transpose(2, 3), offset, None, 3, 1, 1, 1,
                                 1)


def test_dcn_serving_on_cuda_uses_kernel(cuda):
    """bf16 VFNet R50 with DCNv2 C3-C5 (the mdconv config) at a small canvas
    on the card, conv_offset arranged: 13 backbone and 10 head launches per
    request; the float32 network on the card agrees with the CPU's within
    1e-3 * max|out|."""
    cfg = Config.fromfile(VFNET_CFG)
    det, net, _ = init_detector(cfg, device=cuda)
    arrange_offsets(net, seed=0)
    with torch.no_grad():
        net.bbox_head.vfnet_cls.bias.zero_()
    img = np.random.RandomState(1).randint(0, 256, (256, 320, 3), np.uint8)
    before = deform_im2col.launches
    res = inference_detector(det, net, img, scale=(320, 256))
    assert deform_im2col.launches - before == 23
    assert 0 < len(res.scores) <= 100 and np.isfinite(res.bboxes).all()

    cfg.model.compute_dtype = 'float32'
    det32 = build_detector(cfg.model)
    net_cpu = det32.init(seed=2, device='cpu')
    arrange_offsets(net_cpu, seed=0)
    net_dev = copy.deepcopy(net_cpu).to(cuda)
    images = torch.from_numpy(img[None])
    want = det32.forward_raw(net_cpu, images)
    got = det32.forward_raw(net_dev, images.to(cuda))
    for g_l, w_l in zip(got, want):
        for g, w in zip(g_l, w_l):
            torch.testing.assert_close(g.cpu(), w, rtol=0,
                                       atol=1e-3 * float(w.abs().max()))


def test_soft_nms_kernel_above_shared_memory(cuda):
    """K = 12000, above the ~10500 candidates one block holds in shared
    memory: a cluster of 4 blocks an image, 100 steps, linear bit-exact
    and gaussian within 1e-6 relative (the card's expf in both)."""
    boxes, scores = soft_nms_case_cuda(np.random.RandomState(7), cuda, b=2,
                                       k=12000)
    for method in ('linear', 'gaussian'):
        before = soft_nms.launches
        got = soft_nms(boxes, scores, 100, 0.5, 0.5, 1e-3, method)
        torch.cuda.synchronize()
        assert soft_nms.launches == before + 1
        want = soft_nms_plain(boxes, scores, 100, 0.5, 0.5, 1e-3, method)
        assert torch.equal(got[0], want[0])
        if method == 'linear':
            assert torch.equal(got[1], want[1])
        else:
            torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)


def soft_nms_one_block_capacity():
    from erd_tpu_torch.ops import cuda_build
    from erd_tpu_torch.ops.nms import soft_nms_limits
    return soft_nms_limits(cuda_build.load('soft_nms'),
                           torch.device('cuda', 0))[1][1]


def soft_nms_edge_case(cuda, case):
    """(boxes, scores) of a soft-NMS card case (see
    test_soft_nms_kernel_edge_cases)."""
    rs = np.random.RandomState(31)
    cap = soft_nms_one_block_capacity()
    if case == 'ties_across_blocks':
        # disjoint boxes (no decay), a run of equal top scores across the
        # two blocks' slices: selected in index order over the boundary
        k = cap + 1
        half = -(-k // 2)
        x = torch.arange(k, dtype=torch.float32, device=cuda) * 200
        boxes = torch.stack([x, x * 0, x + 100, x * 0 + 100], -1)[None]
        scores = torch.full((1, k), 0.5, device=cuda)
        scores[0, half - 60:half + 60] = 0.875
        scores[0, half - 3] = float('-inf')
    elif case == 'fewer_live_than_steps':
        boxes, scores = soft_nms_case_cuda(rs, cuda, b=2, k=2000)
        keep = torch.zeros_like(scores, dtype=torch.bool)
        keep[0, ::250] = True
        keep[1, 1000:1030] = True
        scores = torch.where(keep, scores, torch.full_like(scores,
                                                           float('-inf')))
    elif case == 'all_inf':
        boxes, scores = soft_nms_case_cuda(rs, cuda, b=2, k=500)
        scores = torch.full_like(scores, float('-inf'))
    elif case in ('at_capacity', 'above_capacity'):
        k = cap if case == 'at_capacity' else cap + 1
        boxes, scores = soft_nms_case_cuda(rs, cuda, b=1, k=k)
    else:  # batch_of_3: live counts 2000, ~1000 and 40 of K = 3000
        boxes, scores = soft_nms_case_cuda(rs, cuda, b=3, k=3000)
        scores[0, 2000:] = float('-inf')
        scores[1, ::2] = float('-inf')
        scores[2, 40:] = float('-inf')
    return boxes.contiguous(), scores.contiguous()


@pytest.mark.parametrize('case', ['ties_across_blocks',
                                  'fewer_live_than_steps', 'all_inf',
                                  'at_capacity', 'above_capacity',
                                  'batch_of_3'])
@pytest.mark.parametrize('method', ['linear', 'gaussian'])
def test_soft_nms_kernel_edge_cases(cuda, case, method):
    """Equal scores across the blocks of a cluster (index order kept over
    the slice boundaries), fewer live candidates than steps and none
    (every later step (0, -inf), jnp.argmax's answer), K at one block's
    capacity and one above, and a batch of 3 images with 2000, ~1000 and
    40 live: selections equal to plain, linear bit-exact, gaussian within
    1e-6 relative; one launch a call. At and above capacity also by the
    plans that one block (at) and a cluster of 2 (above) take, where the
    wrapper's plan takes 4 (more than 3072 slots a block)."""
    from erd_tpu_torch.ops import cuda_build
    from erd_tpu_torch.ops.nms import (soft_nms_launch, soft_nms_limits,
                                       soft_nms_plan)
    boxes, scores = soft_nms_edge_case(cuda, case)
    steps, k = 100, scores.shape[1]
    lib = cuda_build.load('soft_nms')
    threads, capacity = soft_nms_limits(lib, boxes.device)
    plan = soft_nms_plan(k, capacity, threads)
    assert plan[0] == (8 if k > 4 * 3072 else 4 if k > 2 * 3072 else
                       2 if k > 3072 else 1)
    before = soft_nms.launches
    got = soft_nms(boxes, scores, steps, 0.5, 0.5, 1e-3, method)
    torch.cuda.synchronize()
    assert soft_nms.launches == before + 1
    want = soft_nms_plain(boxes, scores, steps, 0.5, 0.5, 1e-3, method)
    if case in ('at_capacity', 'above_capacity'):
        cs = 1 if case == 'at_capacity' else 2
        forced = soft_nms_plan(k, capacity, threads, clusters=(cs,))
        assert forced[0] == cs and forced[1] == -(-k // cs)
        if case == 'at_capacity':
            assert forced[1] == capacity[1]
        alone = soft_nms_launch(lib, boxes, scores, steps, 0.5, 0.5, 1e-3,
                                method, plan=forced)
        assert torch.equal(alone[0], got[0])
        assert torch.equal(alone[1], got[1])
    assert torch.equal(got[0], want[0])
    if method == 'linear':
        assert torch.equal(got[1], want[1])
    else:
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    dead = want[1] == float('-inf')
    assert bool((got[0][dead] == 0).all())
    if case == 'ties_across_blocks':
        half = -(-k // 2)
        run = [i for i in range(half - 60, half + 60) if i != half - 3]
        assert got[0][0].tolist() == run[:steps]
    if case == 'fewer_live_than_steps':
        assert int(dead[0].sum()) == steps - 8 and \
            int(dead[1].sum()) >= steps - 30
    if case == 'all_inf':
        assert bool(dead.all())


def corner_edge_case(cuda, case):
    """(boxes, labels, mask, feat_hw, num_classes, ratio) of a corner-target
    card case (see test_render_corner_targets_kernel_edge_cases)."""
    rs = np.random.RandomState(9)
    if case == 'odd_width':
        fh, fw, b, g = 15, 23, 3, 9   # H * W odd: the scalar stores
    else:
        fh, fw, b, g = 48, 64, 2, 12
    ih, iw = fh * 4, fw * 4
    xy = rs.uniform(-30, max(ih, iw), (b, g, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0, 120, (b, g, 2))], -1)
    labels = rs.randint(-3, 12, (b, g))   # out of range both ways
    valid = rs.rand(b, g) < 0.7
    valid[:, 1] = False                   # invalid between valid ones
    valid[:, 0] = valid[:, 2] = True
    boxes[0, 0] = [0, 0, iw, ih]          # the whole canvas
    boxes[0, 2] = [-40, -25, iw + 50, ih + 9]   # past every edge
    boxes[0, 3] = [30, 20, 30, 20]        # zero size: radius 0
    boxes[0, 4] = [31.5, 22, 90, 80]      # two gts on one tl pixel ...
    boxes[0, 5] = [30.2, 20.9, 70, 50]
    valid[0, 3:6] = True
    labels[0, 4] = labels[0, 5] = 2       # ... of one class
    boxes[1, 0] = [iw - 0.5, ih - 0.5, iw, ih]   # at the bottom-right
    labels = labels.astype(np.int32 if case == 'int32_labels' else np.int64)
    args = [torch.from_numpy(a).to(cuda) for a in (
        boxes.astype(np.float32), labels, valid)]
    return (*args, (fh, fw), 10, (fw / iw, fh / ih))


@pytest.mark.parametrize('case', ['edges', 'odd_width', 'int32_labels'])
def test_render_corner_targets_kernel_edge_cases(cuda, case):
    """Boxes at and past the canvas edge, a zero-size box (radius 0), two
    gts of one class on one corner pixel (the later one's offsets),
    invalid gts between valid ones, labels out of range both ways, int32
    and int64 labels, and H * W odd (scalar stores): heat within 1e-6 of
    plain, the exact-1 peaks, offsets, weights and corner pixels equal;
    one launch a call, every output written (NaN-filled memory beforehand
    leaves no trace)."""
    from erd_tpu_torch.ops.gaussian import (corner_scalars,
                                            render_corner_targets,
                                            render_corner_targets_plain)
    args = corner_edge_case(cuda, case)
    # fill the allocator's free blocks with NaN: an output element the
    # kernel does not write would show
    junk = torch.full((64 << 20,), float('nan'), device=cuda)
    del junk
    before = render_corner_targets.launches
    got = render_corner_targets(*args)
    torch.cuda.synchronize()
    assert render_corner_targets.launches - before == 1
    sc = corner_scalars(*args)
    want = render_corner_targets_plain(sc, args[3], args[4])
    for c in ('tl', 'br'):
        assert float((got[f'{c}_heat'] - want[f'{c}_heat']).abs().max()) \
            <= 1e-6
        assert int((got[f'{c}_heat'] == 1).sum()) == \
            int((want[f'{c}_heat'] == 1).sum()) > 0
        for k in ('off', 'w'):
            assert torch.equal(got[f'{c}_{k}'], want[f'{c}_{k}'])
        assert torch.equal(got[f'{c}_xy'], torch.stack(
            [sc[f'{c}_x'], sc[f'{c}_y']], -1))
    if case == 'edges':
        assert int(sc['radius'][0, 3]) == 0
        assert int(sc['tl_x'][0, 4]) == int(sc['tl_x'][0, 5])
        y, x = int(sc['tl_y'][0, 5]), int(sc['tl_x'][0, 5])
        assert torch.equal(got['tl_off'][0, :, y, x], sc['tl_off'][0, 5])


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in bf16 ulps."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(1, 256, 25, 42), (2, 40, 7, 9),
                                   (2, 256, 100, 168), (2, 13, 11, 50),
                                   (1, 8, 1, 1), (2, 16, 2, 3)])
def test_carafe_kernel_matches_plain(cuda, dtype, shape):
    """The top FPN-CARAFE step of an 800x1344 canvas and its largest, odd
    sizes with a partial channel chunk (13 channels), and 1x1 and 2x3 maps
    where every window is clipped; peaked logits. float32 within 1e-5 *
    max|x|
    (the card's expf and torch's exp may differ by an ulp); bf16 within one
    bf16 ulp (a float32 sum an ulp apart can round to the neighbouring bf16
    value) or, near zero where the taps cancel, within 1e-5 * max|x|."""
    rs = np.random.RandomState(shape[1])
    b, c, h, w = shape
    x = torch.from_numpy(rs.randn(b, c, h, w).astype(np.float32)).to(
        cuda).to(dtype)
    logits = torch.from_numpy((rs.randn(b, 100, h, w) * 2).astype(
        np.float32)).to(cuda).to(dtype)
    before = carafe.launches
    got = carafe(x, logits)
    torch.cuda.synchronize()
    assert carafe.launches == before + 1
    want = carafe_plain(x, logits)
    assert got.dtype == dtype and got.shape == (b, c, 2 * h, 2 * w)
    if dtype == torch.bfloat16:
        near = (got.float() - want.float()).abs() <= \
            1e-5 * float(x.float().abs().max())
        assert bool(((bf16_ulps(got, want) <= 1) | near).all())
    else:
        assert float((got - want).abs().max()) <= \
            1e-5 * float(x.abs().max())
    assert torch.equal(carafe(x.cpu(), logits.cpu()), carafe_plain(
        x.cpu(), logits.cpu()))



@pytest.mark.parametrize('hw', [(25, 42), (50, 84), (100, 168)])
def test_carafe_kernel_differs_from_plain_nowhere_at_the_step_calls(cuda,
                                                                    hw):
    """The three bs-16 bf16 calls of an FPN-CARAFE training step, peaked
    seeded logits: the kernel differs from carafe_plain in no element, as
    the parent design did at every call of the step and of a request (0
    elements, its probe run); the same arithmetic in the same order."""
    rs = np.random.RandomState(hw[0])
    x = torch.from_numpy(rs.randn(16, 256, *hw).astype(np.float32)).to(
        cuda).bfloat16()
    logits = torch.from_numpy((rs.randn(16, 100, *hw) * 2 + rs.randn(
        1, 100, 1, 1) * 2.5).astype(np.float32)).to(cuda).bfloat16()
    got = carafe(x, logits)
    torch.cuda.synchronize()
    assert int((got != carafe_plain(x, logits)).sum()) == 0

def test_set_nms_kernel_matches_plain(cuda):
    """K = 2000 candidates in pairs of near-equal boxes (CrowdDet's two
    instances of a proposal), tied scores, invalid entries: the keep mask
    exactly the plain version's, and not the plain NMS's."""
    rs = np.random.RandomState(8)
    k = 2000
    c = rs.uniform(50, 1300, (6, 2))[rs.randint(6, size=k // 2)] + \
        rs.normal(0, 10, (k // 2, 2))
    wh = rs.uniform(16, 120, (k // 2, 2))
    boxes = np.repeat(np.concatenate([c - wh / 2, c + wh / 2], -1), 2, 0) + \
        rs.normal(0, 1.5, (k, 4))
    scores = np.where(rs.rand(k) > 0.1, rs.randint(0, 50, k) / 50, -np.inf)
    order = np.argsort(-scores, kind='stable')
    args = [torch.from_numpy(np.ascontiguousarray(a))[None].to(cuda)
            for a in (boxes[order].astype(np.float32),
                      scores[order] > -np.inf, (np.arange(k) // 2)[order],
                      order)]
    before = (set_nms_sorted_keep.launches, nms_sorted_keep.launches)
    got = set_nms_sorted_keep(*args, 0.5)
    torch.cuda.synchronize()
    assert (set_nms_sorted_keep.launches, nms_sorted_keep.launches) == \
        (before[0] + 1, before[1])
    assert torch.equal(got, set_nms_sorted_keep_plain(*args, 0.5))
    plain = nms_sorted_keep(args[0], args[1], args[3], 0.5)
    assert int(got.sum()) > int(plain.sum())


@pytest.mark.parametrize('kind', ['random', 'invalid', 'same'])
@pytest.mark.parametrize('b,k', [(2, 1), (2, 63), (2, 64), (2, 65),
                                 (16, 8819)])
def test_set_nms_kernel_matches_plain_at_tile_edges(cuda, kind, b, k):
    """Set-NMS at K = 1, 63-65 and 16 x 8819, groups of two (CrowdDet's
    pairs): random RPN-like boxes, an all-invalid batch, and one box
    repeated (every pair of two groups suppresses): equal to plain."""
    sboxes, svalid, order = rpn_nms_case(np.random.RandomState(k + 1), b, k,
                                         kind=kind)
    sgroup = torch.gather(torch.arange(k).expand(b, k) // 2, 1, order)
    args = [t.to(cuda) for t in (sboxes, svalid, sgroup, order)]
    got = set_nms_sorted_keep(*args, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, set_nms_sorted_keep_plain(*args, 0.5))
    if kind == 'invalid':
        assert int(got.sum()) == 0


def test_tf32_is_off_for_the_ports_float32_conv_backward(cuda):
    """In torch's defaults, the gradients of a float32 layers.Conv2d (input
    and weight; 256 -> 256 channels, 3x3, 50 x 84) agree card vs CPU within
    1e-5 and 1e-4 * max|grad|: autograd runs its backward in full float32
    too (the weight gradient sums 4200 pixels, in another order on each
    side: 1.0e-5 on an H100). The same convolution's backward run in TF32
    (10 mantissa bits) misses both limits."""
    from erd_tpu_torch.models.layers import Conv2d
    gen = torch.Generator().manual_seed(1)
    m = Conv2d(256, 256, 3)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / 48.0)
    x = torch.randn(1, 256, 50, 84, generator=gen)
    r = torch.randn(1, 256, 50, 84, generator=gen)

    def grads(mod, dev, tf32=False):
        mod = copy.deepcopy(mod).to(dev)
        xd = x.to(dev).detach().requires_grad_(True)
        if tf32:
            with conv_fp32_precision('tf32'):
                out = torch.nn.functional.conv2d(xd, mod.weight, mod.bias,
                                                 1, 1)
                (out * r.to(dev)).sum().backward()
        else:
            (mod(xd) * r.to(dev)).sum().backward()
        return xd.grad.cpu(), mod.weight.grad.cpu()

    want = grads(m, 'cpu')
    limits = (1e-5, 1e-4)
    for g, w, lim in zip(grads(m, cuda), want, limits):
        assert float((g - w).abs().max()) <= lim * float(w.abs().max())
    for g, w, lim in zip(grads(m, cuda, tf32=True), want, limits):
        assert float((g - w).abs().max()) > lim * float(w.abs().max())


def test_tf32_is_off_for_the_mask_heads_transposed_conv_backward(cuda):
    """The mask head's 2x2 transposed conv (256 -> 256 channels on 8192 /
    16 RoIs of 14x14, float32): its input and weight gradients card vs CPU
    within 1e-5 and 1e-4 * max|grad|, as the float32 Conv2d's; the same
    transposed conv's backward run in TF32 misses both limits."""
    from erd_tpu_torch.models.heads.mask_head import ConvTranspose2x2
    gen = torch.Generator().manual_seed(2)
    m = ConvTranspose2x2(256, 256)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / 32.0)
    x = torch.randn(512, 256, 14, 14, generator=gen)
    r = torch.randn(512, 256, 28, 28, generator=gen)

    def grads(mod, dev, tf32=False):
        mod = copy.deepcopy(mod).to(dev)
        xd = x.to(dev).detach().requires_grad_(True)
        if tf32:
            with conv_fp32_precision('tf32'):
                out = torch.nn.functional.conv_transpose2d(
                    xd, mod.weight, mod.bias, stride=2)
                (out * r.to(dev)).sum().backward()
        else:
            (mod(xd) * r.to(dev)).sum().backward()
        return xd.grad.cpu(), mod.weight.grad.cpu()

    want = grads(m, 'cpu')
    limits = (1e-5, 1e-4)
    for g, w, lim in zip(grads(m, cuda), want, limits):
        assert float((g - w).abs().max()) <= lim * float(w.abs().max())
    for g, w, lim in zip(grads(m, cuda, tf32=True), want, limits):
        assert float((g - w).abs().max()) > lim * float(w.abs().max())


def test_tf32_is_off_for_the_ports_float32_convs(cuda):
    """In torch's defaults (cuDNN may convolve float32 in TF32), the port's
    ModulatedDeformConv.offsets on a GFL R101-DCN layer3 input (256 x 50 x
    84 at 800x1344) agrees with the CPU within 1e-5 * max|out|; the same
    conv forced into TF32 misses that limit (TF32 keeps 10 mantissa bits:
    about 1e-4 * max|out| here), and the setting comes back afterwards."""
    gen = torch.Generator().manual_seed(0)
    m = ModulatedDeformConv(256, 256, modulated=False)
    with torch.no_grad():
        m.conv_offset.weight.copy_(torch.randn(
            m.conv_offset.weight.shape, generator=gen) / 48.0)
        m.conv_offset.bias.zero_()
    x = torch.randn(1, 256, 50, 84, generator=gen)
    saved = torch.backends.cudnn.conv.fp32_precision \
        if hasattr(torch.backends.cudnn, 'conv') else None
    m.requires_grad_(False)
    want, _ = m.offsets(x)
    got, _ = m.to(cuda).offsets(x.to(cuda))
    limit = 1e-5 * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= limit
    c = m.conv_offset
    with conv_fp32_precision('tf32'):
        tf32 = torch.nn.functional.conv2d(x.to(cuda), c.weight, c.bias, 1, 1)
    assert float((tf32.cpu() - want).abs().max()) > limit
    if saved is not None:
        assert torch.backends.cudnn.conv.fp32_precision == saved


@pytest.mark.parametrize('kind', ['carafe', 'crowddet'])
def test_carafe_and_crowddet_serving_on_cuda_use_kernels(cuda, kind):
    """bf16 ResNet-18 FPN-CARAFE Faster R-CNN or CrowdDet on the card at a
    small canvas: per request 3 CARAFE, 2 NMS and 1 RoIAlign launches, or
    1 NMS, 1 set-NMS and 1 RoIAlign; then the same head outputs
    post-processed on the card and on the CPU agree."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs', {
            'carafe': 'carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py',
            'crowddet': 'crowddet/crowddet-rcnn_r50_fpn_8xb2-30e_'
                        'crowdhuman.py'}[kind])
    cfg = Config.fromfile(path)
    cfg.model.depth = 18
    det, net, _ = init_detector(cfg, device=cuda)
    fns = (carafe, nms_sorted_keep, set_nms_sorted_keep, roi_align)
    img = np.random.RandomState(2).randint(0, 256, (256, 320, 3), np.uint8)
    counts = [f.launches for f in fns]
    res = inference_detector(det, net, img, scale=(320, 256))
    got = [f.launches - c for f, c in zip(fns, counts)]
    assert got == ([3, 2, 0, 1] if kind == 'carafe' else [0, 1, 1, 1])
    assert len(res.scores) <= 100 and np.isfinite(res.bboxes).all()

    rec = ImageRecord(0, '', 320, 256, np.zeros((0, 4), np.float32),
                      np.zeros((0,), np.int32), np.zeros((0,), bool))
    canvas, _, meta = DetPipeline(scale=(320, 256))(rec, image=img)
    images = torch.from_numpy(canvas[None]).to(cuda)
    feats, rpn_cls, rpn_reg = det.feats_and_rpn(net, images)
    meta_gpu = stack_to([meta], cuda)
    rois, _, roi_mask = det.proposals(det.anchor_context(images.shape[1:3]),
                                      rpn_cls, rpn_reg, meta_gpu)
    cls, reg = det.roi_forward(net, det.roi_feats(feats, rois))
    got = det.postprocess(cls, reg, rois, roi_mask, meta_gpu)
    want = det.postprocess(cls.cpu(), reg.cpu(), rois.cpu(), roi_mask.cpu(),
                           stack_to([meta], 'cpu'))
    assert torch.equal(got.mask.cpu(), want.mask)
    assert torch.equal(got.labels.cpu(), want.labels)
    torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(got.bboxes.cpu(), want.bboxes, rtol=0,
                               atol=1e-2)


# ----------------------------------------------- training (backward kernels)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype):
    """512 RoIs an image, 2 images, on P2-P5 of a 400x672 canvas (64
    channels), with off-image, degenerate and last-row/column boxes. The
    float32 buffers agree within 1e-5 * max|g| (atomics add in an order
    that changes from run to run); rounded to the maps' dtype, within one
    bf16 ulp of the plain version's rounding or 1e-5 * max|g|."""
    from erd_tpu_torch.ops import roi_align_backward, roi_align_backward_plain
    rs = np.random.RandomState(15)
    shapes = [(100, 168), (50, 84), (25, 42), (13, 21)]
    b, r, c = 2, 512, 64
    xy = rs.uniform(-30, [672, 400], (b, r, 2))
    wh = np.exp(rs.uniform(np.log(2), np.log(600), (b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, :5] = [[0, 0, 0, 0], [640, 380, 672, 400], [-60, -40, -2, -1],
                   [10, 10, 10, 10], [0, 396, 672, 400]]
    rois = torch.from_numpy(rois).to(cuda)
    levels = map_roi_levels(rois, 4)
    assert len(torch.unique(levels)) == 4
    grad = torch.from_numpy(rs.randn(b, r, c, 7, 7).astype(np.float32)).to(
        cuda)
    before = roi_align_backward.launches
    got32 = roi_align_backward(grad, rois, levels, shapes)
    got = roi_align_backward(grad, rois, levels, shapes, dtype=dtype)
    torch.cuda.synchronize()
    assert roi_align_backward.launches == before + 2
    want = roi_align_backward_plain(grad, rois, levels, shapes,
                                    (4, 8, 16, 32))
    for g32, g, w in zip(got32, got, want):
        limit = 1e-5 * float(w.abs().max())
        assert g.dtype == dtype and g.shape == (b, c) + tuple(w.shape[2:])
        assert float((g32 - w).abs().max()) <= limit
        near = (g.float() - w).abs() <= limit
        if dtype == torch.bfloat16:
            assert bool(((bf16_ulps(g, w.to(dtype)) <= 1) | near).all())
        else:
            assert bool(near.all())


def test_roi_align_autograd_on_cuda_uses_the_backward_kernel(cuda):
    feats = [torch.randn(1, 8, h, w, device=cuda, requires_grad=True)
             for h, w in ((20, 24), (10, 12), (5, 6), (3, 3))]
    rois = torch.tensor([[[4.0, 4.0, 60.0, 50.0], [0, 0, 96, 80],
                          [10, 20, 30, 40]]], device=cuda)
    counts = (roi_align.launches, roi_align_backward_launches())
    out = multilevel_roi_align(feats, rois)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert (roi_align.launches, roi_align_backward_launches()) == \
        (counts[0] + 1, counts[1] + 1)
    assert all(f.grad is not None for f in feats)


def roi_align_backward_launches():
    from erd_tpu_torch.ops import roi_align_backward
    return roi_align_backward.launches


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(2, 256, 25, 42), (2, 40, 7, 9),
                                   (1, 256, 100, 168), (2, 20, 37, 45),
                                   (2, 13, 1, 1), (1, 9, 2, 3)])
def test_carafe_backward_kernel_matches_plain(cuda, dtype, shape):
    """The top FPN-CARAFE step of an 800x1344 canvas at batch 2 and its
    largest at batch 1, odd sizes (37 x 45: ragged tiles), channel counts
    that leave a partial chunk (13, 20, 9), and 1 x 1 and 2 x 3 maps where
    every window is clipped; peaked logits. dx and dlogits within 1e-5 *
    max|plain| in float32 (sums over taps and channels in another order);
    in bf16 within one bf16 ulp or 1e-5 * max|plain|."""
    from erd_tpu_torch.ops import carafe_backward, carafe_backward_plain
    rs = np.random.RandomState(shape[1] + 1)
    b, c, h, w = shape
    x = torch.from_numpy(rs.randn(b, c, h, w).astype(np.float32)).to(
        cuda).to(dtype)
    logits = torch.from_numpy((rs.randn(b, 100, h, w) * 2).astype(
        np.float32)).to(cuda).to(dtype)
    g = torch.from_numpy(rs.randn(b, c, 2 * h, 2 * w).astype(
        np.float32)).to(cuda).to(dtype)
    before = carafe_backward.launches
    dx, dl = carafe_backward(x, logits, g)
    torch.cuda.synchronize()
    assert carafe_backward.launches == before + 1
    wx, wl = carafe_backward_plain(x, logits, g)
    for got, want in ((dx, wx), (dl, wl)):
        assert got.dtype == dtype and got.shape == want.shape
        near = (got.float() - want.float()).abs() <= \
            1e-5 * float(want.float().abs().max())
        if dtype == torch.bfloat16:
            assert bool(((bf16_ulps(got, want) <= 1) | near).all())
        else:
            assert bool(near.all())


def test_carafe_autograd_on_cuda_uses_the_backward_kernel(cuda):
    from erd_tpu_torch.ops import carafe_backward
    x = torch.randn(1, 16, 5, 6, device=cuda, requires_grad=True)
    lg = torch.randn(1, 100, 5, 6, device=cuda, requires_grad=True)
    counts = (carafe.launches, carafe_backward.launches)
    carafe(x, lg).square().sum().backward()
    assert (carafe.launches, carafe_backward.launches) == \
        (counts[0] + 1, counts[1] + 1)
    assert x.grad is not None and lg.grad is not None


def test_backward_functions_pass_gradcheck_on_the_plain_path():
    """Finite differences in float64 of the RoIAlign, CARAFE and
    deformable-attention autograd Functions on the plain path (CPU
    tensors, the kernels' reference), at a tiny size."""
    gen = torch.Generator().manual_seed(0)
    fs = [torch.randn(1, 2, h, w, generator=gen, dtype=torch.float64)
          .requires_grad_() for h, w in ((5, 6), (3, 3))]
    rois = torch.tensor([[[1.0, 2.0, 13.0, 15.0], [-3.0, 10.0, 25.0, 22.0],
                          [2.0, 1.0, 30.0, 20.0]]])
    levels = torch.tensor([[0, 0, 1]], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda *f: roi_align(list(f), rois, levels, (4, 8)), tuple(fs))
    x = torch.randn(1, 2, 2, 3, generator=gen, dtype=torch.float64)
    lg = torch.randn(1, 100, 2, 3, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        carafe, (x.requires_grad_(), lg.requires_grad_()))
    shapes = [(3, 4), (2, 2)]
    v = torch.randn(1, 16, 2, 3, generator=gen, dtype=torch.float64)
    lc = torch.rand(1, 3, 2, 2, 2, 2, generator=gen,
                    dtype=torch.float64) * 1.4 - 0.2
    w = torch.rand(1, 3, 2, 2, 2, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b, c: ms_deform_attn(a, shapes, b, c),
        (v.requires_grad_(), lc.requires_grad_(), w.requires_grad_()))


def test_ms_deform_attn_refuses_gradients_on_cuda(cuda):
    """The name is from before the backward was ported: now a CUDA input
    that needs a gradient runs the forward kernel, and autograd launches
    the backward kernel once, whose gradients agree with the plain
    version's (values within 1e-5 * max|plain|: float32 atomics reorder
    the sums); under no_grad only the forward kernel runs."""
    from erd_tpu_torch.ops import (ms_deform_attn_backward,
                                   ms_deform_attn_backward_plain)
    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(3, 5), (2, 3)]
    values = torch.randn(2, 21, 8, 32, device=cuda, generator=gen)
    locs = torch.rand(2, 7, 8, 2, 4, 2, device=cuda, generator=gen) * 1.4 \
        - 0.2
    weights = torch.rand(2, 7, 8, 2, 4, device=cuda, generator=gen)
    g = torch.randn(2, 7, 8, 32, device=cuda, generator=gen)
    counts = (ms_deform_attn.launches, ms_deform_attn_backward.launches)
    with torch.no_grad():
        out = ms_deform_attn(values, shapes, locs, weights)
    assert out.shape == (2, 7, 8, 32)
    leaves = [t.clone().requires_grad_() for t in (values, locs, weights)]
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    assert out.grad_fn is not None
    out.backward(g)
    torch.cuda.synchronize()
    assert (ms_deform_attn.launches, ms_deform_attn_backward.launches) == \
        (counts[0] + 2, counts[1] + 1)
    want = ms_deform_attn_backward_plain(values, shapes, locs, weights, g)
    for leaf, w in zip(leaves, want):
        assert float((leaf.grad - w).abs().max()) <= \
            1e-5 * float(w.abs().max())


@pytest.mark.parametrize('kind', ['frcnn', 'carafe', 'crowddet'])
def test_two_stage_training_on_cuda_uses_kernels(cuda, kind):
    """Two fit steps of each config at depth 18, bf16, batch 2, 256x320 on
    the card: finite losses, the forward and backward kernels of the path
    launched every step (RoIAlign, the RPN NMS; CARAFE for FPN-CARAFE),
    the frozen stages unchanged."""
    from erd_tpu_torch.apis import build_trainer
    from erd_tpu_torch.engine import Hook, resnet_frozen_paths
    from erd_tpu_torch.ops import carafe_backward, roi_align_backward
    from erd_tpu_torch.structures import GTInstances, ImageMeta
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(root, 'configs', {
        'frcnn': 'faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py',
        'carafe': 'carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py',
        'crowddet': 'crowddet/crowddet-rcnn_r50_fpn_8xb2-30e_'
                    'crowdhuman.py'}[kind]))
    cfg.model.depth = 18
    cfg.train_cfg.epochs = 1
    det = build_detector(cfg.model)
    net = det.init(seed=0, device=cuda)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    rs = np.random.RandomState(4)
    gt = stack_to([GTInstances.pad(np.array([[20, 30, 120, 150],
                                             [150, 40, 300, 200]],
                                            np.float32), [0, 0], 4)] * 2,
                  cuda)
    batch = dict(images=torch.from_numpy(rs.randint(
        0, 256, (2, 256, 320, 3), np.uint8)).to(cuda), gt=gt,
        meta=stack_to([ImageMeta.make((256, 320), (256, 320), (1.0, 1.0),
                                      img_id=i) for i in range(2)], cuda))

    class Loader:
        cfg = type('LoaderConfig', (), {'batch_size': 2})()

        def steps_per_epoch(self, epoch):
            return 2

        def epoch(self, epoch):
            yield batch
            yield batch
    fns = (roi_align, roi_align_backward, nms_sorted_keep, carafe,
           carafe_backward)
    counts = [f.launches for f in fns]
    class Record(Hook):
        def after_iter(self, trainer, step, step_losses):
            losses.append(step_losses)
    trainer = build_trainer(cfg, det, Loader(), device=cuda)
    losses = []
    trainer.hooks.append(Record())
    trainer.fit(net)
    got = [f.launches - c for f, c in zip(fns, counts)]
    steps = 2 if kind == 'carafe' else 0
    assert got == [2, 2, 2, 3 * steps, 3 * steps], got
    assert all(np.isfinite(v) for l in losses for v in l.values())
    frozen = resnet_frozen_paths(1)
    for k, v in net.state_dict().items():
        if k.startswith(frozen):
            assert torch.equal(v, start[k]), k


def bf16_ulp_distance(a, b):
    """Elementwise distance of two bf16 tensors in bf16 ulps."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('dg,stride,use_mask,border', [
    (1, 1, True, False), (1, 2, False, False), (2, 1, False, True),
    (2, 2, True, False)])
def test_deform_im2col_backward_kernel_matches_plain(cuda, dtype, dg, stride,
                                                     use_mask, border):
    """The backward kernel against its plain version on a layer4-sized map
    (Cin 128, 25 x 42), fractional or border-exact offsets: the offset and
    mask gradients within 1e-5 * max|plain| (channel sums in another
    order), the map gradient within 1e-5 * max|plain| in float32 (float32
    atomics add in no fixed order), and when it is rounded to a bf16 map
    within one bf16 ulp or 1e-5 * max|plain|."""
    from erd_tpu_torch.ops import (deform_im2col_backward,
                                   deform_im2col_backward_plain)
    rs = np.random.RandomState(dg * 100 + stride * 10 + int(border) + 7)
    x, offset, mask = dcn_case(rs, cuda, dtype, 2, 128, 25, 42, dg, stride,
                               2.5, border)
    mask = mask if use_mask else None
    g = torch.from_numpy(rs.randn(2, 128 * 9, offset.shape[2] *
                                  offset.shape[3]).astype(np.float32)).to(cuda)
    args = (x, offset, mask, g, 3, stride, 1, 1, dg)
    before = deform_im2col_backward.launches
    got = deform_im2col_backward(*args)
    torch.cuda.synchronize()
    assert deform_im2col_backward.launches == before + 1
    want = deform_im2col_backward_plain(*args)
    assert got[0].dtype == dtype and (got[2] is None) == (mask is None)
    for name, a, w in zip(('offset', 'mask'), got[1:], want[1:]):
        if w is not None:
            assert float((a - w).abs().max()) <= \
                1e-5 * float(w.abs().max()), name
    diff = (got[0].float() - want[0]).abs()
    far = diff > 1e-5 * float(want[0].abs().max())
    if dtype == torch.float32:
        assert not bool(far.any())
    else:  # near 0 a cancelling sum may round to bf16 values ulps apart
        ulps = bf16_ulp_distance(got[0], want[0].bfloat16())
        assert bool(((ulps <= 1) | ~far).all())


def test_deform_im2col_backward_never_reaches_plain_on_cuda(cuda,
                                                            monkeypatch):
    """On CUDA tensors autograd launches the forward and the backward
    kernel once each and never calls a plain version; wrong dtypes and
    mixed devices raise."""
    import erd_tpu_torch.ops.deform_conv as dcn_module

    def refuse(*args, **kw):
        raise AssertionError('a plain version ran on a CUDA tensor')
    monkeypatch.setattr(dcn_module, 'deform_im2col_plain', refuse)
    monkeypatch.setattr(dcn_module, 'deform_im2col_backward_plain', refuse)
    x, offset, mask = dcn_case(np.random.RandomState(0), cuda,
                               torch.bfloat16, 1, 16, 9, 10, 1, 1, 1.0, False)
    leaves = [t.clone().requires_grad_() for t in (x, offset, mask)]
    counts = (dcn_module.deform_im2col.launches,
              dcn_module.deform_im2col_backward.launches)
    cols = dcn_module.deform_im2col(*leaves, 3, 1, 1, 1, 1)
    cols.square().sum().backward()
    torch.cuda.synchronize()
    assert (dcn_module.deform_im2col.launches,
            dcn_module.deform_im2col_backward.launches) == \
        (counts[0] + 1, counts[1] + 1)
    assert leaves[0].grad.dtype == torch.bfloat16
    assert all(t.grad is not None for t in leaves)
    g = torch.ones_like(cols)
    with pytest.raises(TypeError, match='float32'):
        dcn_module.deform_im2col_backward(x, offset.double(), mask, g)
    with pytest.raises(ValueError, match='one device'):
        dcn_module.deform_im2col_backward(x, offset, mask, g.cpu())


def check_deform_backward(got, want, dtype):
    """The backward kernel's gradients against the plain ones: offsets and
    masks within 1e-5 * max|plain|, the map within 1e-5 * max|plain| in
    float32 and, rounded to a bf16 map, within one bf16 ulp beyond it."""
    assert got[0].dtype == dtype and (got[2] is None) == (want[2] is None)
    for name, a, w in zip(('offset', 'mask'), got[1:], want[1:]):
        if w is not None:
            assert float((a - w).abs().max()) <= \
                1e-5 * float(w.abs().max()), name
    far = (got[0].float() - want[0]).abs() > 1e-5 * float(
        want[0].abs().max())
    if dtype == torch.float32:
        assert not bool(far.any())
    else:
        ulps = bf16_ulp_distance(got[0], want[0].bfloat16())
        assert bool(((ulps <= 1) | ~far).all())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('reach', ['star', 'far', 'planes'])
def test_deform_im2col_backward_kernel_combines_a_warps_adds(cuda, dtype,
                                                             reach):
    """The map gradient's adds combined in each warp, against the plain
    version: star offsets (each kernel point 7 px out along its direction,
    +- 0.6 px of jitter: lanes whose corners coincide, runs, gaps, rows
    split); offsets of 30 px (corners far off the map); 47 x 45 maps (19035
    samples a plane set: warps straddle plane sets), 4 of them."""
    from erd_tpu_torch.ops.deform_conv import (deform_im2col_backward,
                                               deform_im2col_backward_plain)
    rs = np.random.RandomState(11)
    b, cin, h, w = (4, 16, 47, 45) if reach == 'planes' else (2, 32, 100, 168)
    x, offset, _ = dcn_case(rs, cuda, dtype, b, cin, h, w, 1, 1,
                            30.0 if reach == 'far' else 2.5, False)
    if reach == 'star':
        ky, kx = np.divmod(np.arange(9), 3)
        star = np.stack([ky - 1, kx - 1], -1).astype(np.float32) * 7.0
        off = star[None, :, :, None, None] + rs.normal(
            0, 0.6, (b, 9, 2, h, w))
        offset = torch.from_numpy(off.reshape(b, 18, h, w).astype(
            np.float32)).to(cuda)
    g = torch.from_numpy(rs.randn(b, cin * 9, h * w).astype(
        np.float32)).to(cuda)
    args = (x, offset, None, g, 3, 1, 1, 1, 1)
    before = deform_im2col_backward.launches
    got = deform_im2col_backward(*args)
    torch.cuda.synchronize()
    assert deform_im2col_backward.launches == before + 1
    check_deform_backward(got, deform_im2col_backward_plain(*args), dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('dg,stride', [(1, 2), (2, 1), (2, 2)])
def test_deform_im2col_backward_kernel_stride_and_groups(cuda, dtype, dg,
                                                         stride):
    """Stride 2 and 2 deform groups on an R101 layer3-like map (Cin 64,
    50 x 84; a layer2-like 100 x 168 at stride 2), DCNv2, offsets of a
    per-point bias and a small per-pixel part (the path's arranged
    conv_offset): the kernel against its plain version."""
    from erd_tpu_torch.ops.deform_conv import (deform_im2col_backward,
                                               deform_im2col_backward_plain)
    h, w = (100, 168) if stride == 2 else (50, 84)
    rs = np.random.RandomState(dg * 10 + stride)
    x, _, mask = dcn_case(rs, cuda, dtype, 2, 64, h, w, dg, stride, 2.5,
                          False)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    off = rs.normal(0, 1.5, (1, dg * 18, 1, 1)) + rs.normal(
        0, 0.05, (2, dg * 18, ho, wo))
    offset = torch.from_numpy(off.astype(np.float32)).to(cuda)
    g = torch.from_numpy(rs.randn(2, 64 * 9, ho * wo).astype(
        np.float32)).to(cuda)
    args = (x, offset, mask, g, 3, stride, 1, 1, dg)
    check_deform_backward(deform_im2col_backward(*args),
                          deform_im2col_backward_plain(*args), dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_deform_im2col_backward_kernel_every_chunk(cuda, dtype):
    """The map-gradient threads on chunks of the group's channels: all of
    them (one walk for both gradients), 64, 16 and 7 (a ragged last
    chunk), with the offset and mask gradients then in blocks of their
    own; each against the plain version, and the offset and mask
    gradients bit-equal across the chunks (the same sums in the same
    order)."""
    from erd_tpu_torch.ops.deform_conv import (_backward_launch,
                                               deform_im2col_backward_plain)
    rs = np.random.RandomState(13)
    x, offset, mask = dcn_case(rs, cuda, dtype, 2, 128, 25, 42, 1, 1, 3.0,
                               False)
    g = torch.from_numpy(rs.randn(2, 128 * 9, 25 * 42).astype(
        np.float32)).to(cuda)
    args = (x, offset, mask, g, 3, 1, 1, 1, 1)
    want = deform_im2col_backward_plain(*args)
    first = None
    for chunk in (128, 64, 16, 7):
        gx, goff, gmask = _backward_launch(*args, True, True, chunk)
        torch.cuda.synchronize()
        check_deform_backward((gx.to(dtype), goff, gmask), want, dtype)
        if first is None:
            first = (goff, gmask)
        assert torch.equal(goff, first[0]) and torch.equal(gmask, first[1])
        only = _backward_launch(*args, False, True, chunk)
        assert only[0] is None and torch.equal(only[1], first[0])


def test_deform_im2col_backward_offset_gradients_repeat_bit_for_bit(cuda):
    """The offset and mask gradients sum the channels in order: two calls
    give them bit for bit (the map gradient's atomics may reorder), as do
    the calls that ask for the offsets' alone."""
    from erd_tpu_torch.ops.deform_conv import deform_im2col_backward
    rs = np.random.RandomState(5)
    x, offset, mask = dcn_case(rs, cuda, torch.bfloat16, 2, 256, 50, 84, 1,
                               1, 3.0, False)
    g = torch.from_numpy(rs.randn(2, 256 * 9, 50 * 84).astype(
        np.float32)).to(cuda)
    args = (x, offset, mask, g, 3, 1, 1, 1, 1)
    a, b = deform_im2col_backward(*args), deform_im2col_backward(*args)
    only = deform_im2col_backward(*args, need_x=False)
    assert only[0] is None
    for i in (1, 2):
        assert torch.equal(a[i], b[i]) and torch.equal(a[i], only[i])


def encoder_case(rs, device, b, q=None, shapes=None):
    """An encoder-shaped sampling call (8 heads, 4 levels x 4 points, head
    width 32): values, locations in [-0.1, 1.1], softmaxed weights, an
    output gradient."""
    shapes = shapes or DETR_LEVELS['landscape']
    n = sum(h * w for h, w in shapes)
    q = n if q is None else q
    levels = len(shapes)
    values = rs.randn(b, n, 8, 32).astype(np.float32)
    locs = rs.uniform(-0.1, 1.1, (b, q, 8, levels, 4, 2)).astype(np.float32)
    w = rs.rand(b, q, 8, levels * 4).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    g = rs.randn(b, q, 8, 32).astype(np.float32)
    return [torch.from_numpy(t).to(device) for t in (
        values, locs, w.reshape(b, q, 8, levels, 4), g)]


def check_attn_backward(got, want):
    for name, a, w in zip(('values', 'locations', 'weights'), got, want):
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max()), \
            name


def test_ms_deform_attn_backward_kernel_on_the_coarsest_level(cuda):
    """The encoder's call at batch 2 with every live sample on level 3
    (13 x 21), most of them in one 3 x 3 corner of it (the worst
    contention), the other levels' samples off their maps: the kernel
    agrees with its plain version, in one launch."""
    from erd_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_backward, ms_deform_attn_backward_plain)
    rs = np.random.RandomState(3)
    shapes = DETR_LEVELS['landscape']
    values, locs, weights, g = encoder_case(rs, cuda, 2)
    locs[:, :, :, :3] = -2.0
    corner = torch.rand(locs[:, :, :, 3].shape, device=cuda) < 0.8
    locs[:, :, :, 3] = torch.where(corner, locs[:, :, :, 3] * 0.15,
                                   locs[:, :, :, 3])
    args = (values, shapes, locs, weights, g)
    want = ms_deform_attn_backward_plain(*args)
    before = ms_deform_attn_backward.launches
    check_attn_backward(ms_deform_attn_backward(*args), want)
    assert ms_deform_attn_backward.launches == before + 1


@pytest.mark.parametrize('q', [300, 996])
def test_ms_deform_attn_backward_kernel_at_decoder_shapes(cuda, q):
    """The decoders' calls (Q = 300, and DINO's 900 + 96 denoising
    queries) at batch 16 on the 800 x 1344 levels, on blocks of 8 queries:
    the kernel against its plain version."""
    from erd_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_backward, ms_deform_attn_backward_plain,
        ms_deform_attn_backward_run)
    rs = np.random.RandomState(q)
    shapes = DETR_LEVELS['landscape']
    values, locs, weights, g = encoder_case(rs, cuda, 16, q)
    assert ms_deform_attn_backward_run(16, q, 8) == 8
    args = (values, shapes, locs, weights, g)
    check_attn_backward(ms_deform_attn_backward(*args),
                        ms_deform_attn_backward_plain(*args))


def test_vfnet_training_on_cuda_uses_kernels(cuda):
    """Two fit steps of VFNet R50-mdconv (bf16, batch 2, 256x320,
    conv_offset arranged) on the card: 23 im2col and 23 im2col backward
    launches a step, finite losses, the frozen stages unchanged and every
    conv_offset moved."""
    from erd_tpu_torch.apis import build_trainer
    from erd_tpu_torch.engine import Hook, resnet_frozen_paths
    from erd_tpu_torch.ops import deform_im2col_backward
    from erd_tpu_torch.structures import ImageMeta
    cfg = Config.fromfile(VFNET_CFG)
    cfg.train_cfg.epochs = 1
    det = build_detector(cfg.model)
    net = det.init(seed=0, device=cuda)
    arrange_offsets(net, seed=0)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    rs = np.random.RandomState(4)
    gt = stack_to([GTInstances.pad(np.array([[20, 30, 120, 150],
                                             [150, 40, 300, 200]],
                                            np.float32), [0, 3], 4)] * 2,
                  cuda)
    batch = dict(images=torch.from_numpy(rs.randint(
        0, 256, (2, 256, 320, 3), np.uint8)).to(cuda), gt=gt,
        meta=stack_to([ImageMeta.make((256, 320), (256, 320), (1.0, 1.0),
                                      img_id=i) for i in range(2)], cuda))

    class Loader:
        cfg = type('LoaderConfig', (), {'batch_size': 2})()

        def steps_per_epoch(self, epoch):
            return 2

        def epoch(self, epoch):
            yield batch
            yield batch

    class Record(Hook):
        def after_iter(self, trainer, step, step_losses):
            losses.append(step_losses)
    counts = (deform_im2col.launches, deform_im2col_backward.launches)
    trainer = build_trainer(cfg, det, Loader(), device=cuda)
    losses = []
    trainer.hooks.append(Record())
    trainer.fit(net)
    assert (deform_im2col.launches - counts[0],
            deform_im2col_backward.launches - counts[1]) == (46, 46)
    assert all(np.isfinite(v) for l in losses for v in l.values())
    frozen = resnet_frozen_paths(1)
    for k, v in net.state_dict().items():
        moved = not torch.equal(v, start[k])
        assert not (k.startswith(frozen) and moved), k
        if '.conv_offset.weight' in k:
            assert moved, k


# ------------------------- Mask R-CNN, PointRend, CornerNet (serving)
def point_sample_case(rs, device, dtype, form):
    """PointRend's two call forms at small sizes: per-RoI 14x14 coarse
    logits (channels-last, as the coarse head's view) at their own
    points, or one P2 map per image at all its RoIs' points; the edges 0
    and 1 put two corners of a sample off the map."""
    from erd_tpu_torch.models.detectors.point_rend import cell_centres
    if form == 'coarse':
        maps = torch.from_numpy(rs.randn(30, 14, 14, 80).astype(
            np.float32) * 3).permute(0, 3, 1, 2)
        pts = cell_centres(torch.from_numpy(rs.randint(0, 784, (30, 196))),
                           28)
        pts[:, :4] = torch.tensor([[0., 0.], [1., 1.], [0., 1.], [1., 0.]])
    else:
        maps = torch.from_numpy(rs.randn(2, 256, 50, 84).astype(np.float32))
        pts = torch.from_numpy(rs.uniform(-0.02, 1.02, (2, 1960, 2)).astype(
            np.float32))
    return maps.to(device=device, dtype=dtype), pts.to(device)


@pytest.mark.parametrize('form', ['coarse', 'fine'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_point_sample_kernel_matches_plain(cuda, form, dtype):
    from erd_tpu_torch.ops import point_sample, point_sample_plain
    maps, pts = point_sample_case(np.random.RandomState(0), cuda, dtype,
                                  form)
    before = point_sample.launches
    got = point_sample(maps, pts)
    torch.cuda.synchronize()
    assert point_sample.launches - before == 1
    want = point_sample_plain(maps, pts)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    # NCHW memory reads the same as channels-last
    assert torch.equal(point_sample(maps.contiguous(), pts), got)


def point_train_case(rs, device, form):
    """PointRend's four training call forms (maps, points) at reduced
    counts but the path's widths and layouts: the uncertainty and target
    calls on one-channel 14x14 maps (588 / 196 points, as the step's
    ``coarse_at[:, None]`` / ``mt14[:, None]``), the coarse call on 80
    channels-last float32 14x14 maps, the fine call on a channels-last bf16
    P2 of 256 channels at the points of 12 RoIs an image; points uniform
    over [-0.05, 1.05]^2 (some off the map) and the four corners."""
    def pts(n, k):
        p = rs.uniform(-0.05, 1.05, (n, k, 2)).astype(np.float32)
        p[:, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
        return torch.from_numpy(p).to(device)
    if form in ('uncertainty', 'targets'):
        k = 588 if form == 'uncertainty' else 196
        maps = torch.from_numpy(rs.randn(37, 14, 14).astype(np.float32))
        return maps.to(device)[:, None], pts(37, k)
    if form == 'coarse':  # enough maps for the staged layout's blocks
        maps = torch.from_numpy(rs.randn(300, 14, 14, 80).astype(
            np.float32))
        return maps.to(device).permute(0, 3, 1, 2), pts(300, 196)
    maps = torch.from_numpy(rs.randn(2, 50, 84, 256).astype(np.float32))
    return maps.to(device=device, dtype=torch.bfloat16).permute(
        0, 3, 1, 2), pts(2, 12 * 196)


def point_forced_plans(maps, k):
    """{name: plan}: the plan's layout, and every other layout that takes
    these maps (staged at 1, 3 and 8 maps a block where they fit, by
    16-byte copies where the maps are dense and aligned and element by
    element, the unit-stride layout in 32- and 64-bit index math where the
    channels allow it, the general one)."""
    from erd_tpu_torch.ops.sampling import (STAGE_BYTES, PointSamplePlan,
                                            point_sample_plan)
    plan = point_sample_plan(tuple(maps.shape), maps.stride(), maps.dtype, k,
                             maps.data_ptr())
    out = {'plan': plan, 'general': PointSamplePlan('general')}
    n, c, h, w = maps.shape
    sn, sc, sy, sx = maps.stride()
    per_map = -(-c * h * w * maps.element_size() // 16) * 16 + (
        24 * k if c > 1 else 0)
    dense = sx == c and sy == w * c and (c == 1 or sc == 1) and \
        c * h * w * maps.element_size() % 16 == 0 and \
        sn * maps.element_size() % 16 == 0 and maps.data_ptr() % 16 == 0
    for g in (1, 3, 8):
        if g * per_map <= STAGE_BYTES:
            out[f'staged {g}'] = PointSamplePlan('staged', g, dense)
            if dense:
                out[f'staged {g} by elements'] = PointSamplePlan('staged', g)
    vec = 16 // maps.element_size()
    if sc == 1 and maps.shape[1] % vec == 0 and \
            maps.data_ptr() % 16 == 0 and \
            all(v % vec == 0 for v in (sn, sy, sx)):
        out['unit'] = PointSamplePlan('unit')
        out['unit wide'] = PointSamplePlan('unit', wide=True)
    return out


@pytest.mark.parametrize('form', ['uncertainty', 'coarse', 'fine',
                                  'targets'])
def test_point_sample_kernel_layouts_match_plain_exactly(cuda, form):
    """Every layout of the forward at each PointRend training call form,
    the plan's and each other one that takes the maps, one launch each,
    equal to the plain version to the bit; the plan stages the one-channel
    and (300 of them) the 80-channel 14x14 maps and takes the bf16 P2 by
    unit-stride channels."""
    from erd_tpu_torch.ops.sampling import (point_sample,
                                            point_sample_launch,
                                            point_sample_plain)
    maps, pts = point_train_case(np.random.RandomState(11), cuda, form)
    want = point_sample_plain(maps, pts)
    plans = point_forced_plans(maps, pts.shape[1])
    assert plans['plan'].layout == ('unit' if form == 'fine' else 'staged')
    for name, plan in plans.items():
        before = point_sample.launches
        got = point_sample_launch(maps, pts, plan)
        torch.cuda.synchronize()
        assert point_sample.launches - before == 1, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize('case', ['nchw_bf16', 'offset', 'strided_pick',
                                  'three_channels', 'bf16_coarse'])
def test_point_sample_kernel_other_layouts_match_plain_exactly(cuda, case):
    """Maps no model path gives, each in every layout that takes it: an
    NCHW bf16 P2 and a map 4 bytes past a 16-byte boundary (the general
    layout), one channel of channels-last logits (staged element by element
    through its strides), 3 channels (staged a channel a thread), five
    bf16 14x14 maps (too few blocks to stage: unit-stride channels; staged
    too, 8-byte vectors)."""
    from erd_tpu_torch.ops.sampling import (point_sample_launch,
                                            point_sample_plain)
    rs = np.random.RandomState(12)
    pts = torch.from_numpy(rs.uniform(-0.05, 1.05, (5, 300, 2)).astype(
        np.float32)).to(cuda)
    if case == 'nchw_bf16':  # too large a map to stage (169 KB)
        maps = torch.randn(5, 128, 20, 33, device=cuda).to(torch.bfloat16)
    elif case == 'offset':
        flat = torch.randn(5 * 64 * 20 * 33 + 1, device=cuda)
        maps = flat[1:].view(5, 20, 33, 64).permute(0, 3, 1, 2)
        assert maps.data_ptr() % 16 == 4
    elif case == 'strided_pick':
        logits = torch.randn(5, 14, 14, 80, device=cuda).permute(0, 3, 1, 2)
        maps = logits[:, 7:8]  # strides (15680, 1, 1120, 80)
    elif case == 'three_channels':
        maps = torch.randn(5, 3, 14, 14, device=cuda)
    else:
        maps = torch.randn(5, 14, 14, 40, device=cuda).to(
            torch.bfloat16).permute(0, 3, 1, 2)
    want = point_sample_plain(maps, pts)
    plans = point_forced_plans(maps, pts.shape[1])
    layout = {'nchw_bf16': 'general', 'offset': 'general',
              'bf16_coarse': 'unit'}.get(case, 'staged')
    assert plans['plan'].layout == layout, plans['plan']
    for name, plan in plans.items():
        got = point_sample_launch(maps, pts, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


def test_point_sample_kernel_refuses_plans_that_do_not_fit(cuda):
    """A forced layout the maps do not allow is refused by the kernel, and
    the launch raises: the unit-stride layout on NCHW maps or on a map off
    16 bytes, the staged layout past the shared memory of a block."""
    from erd_tpu_torch.ops.sampling import PointSamplePlan, point_sample_launch
    pts = torch.rand(2, 50, 2, device=cuda)
    nchw = torch.randn(2, 64, 20, 33, device=cuda)
    with pytest.raises(RuntimeError, match='unit'):
        point_sample_launch(nchw, pts, PointSamplePlan('unit'))
    flat = torch.randn(2 * 16 * 20 * 33 + 1, device=cuda)
    off = flat[1:].view(2, 20, 33, 16).permute(0, 3, 1, 2)
    with pytest.raises(RuntimeError, match='unit'):
        point_sample_launch(off, pts, PointSamplePlan('unit'))
    big = torch.randn(2, 256, 20, 33, device=cuda)
    with pytest.raises(RuntimeError, match='staged'):
        point_sample_launch(big, pts, PointSamplePlan('staged'))


@pytest.mark.parametrize('direction', ['top', 'bottom', 'left', 'right'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(1, 128, 192, 256), (2, 3, 37, 19),
                                   (1, 2, 1, 5), (1, 3, 1, 1), (1, 2, 31, 33),
                                   (1, 2, 33, 31), (2, 2, 128, 128),
                                   (1, 2, 257, 300), (1, 2, 300, 257),
                                   (1, 2, 5, 264), (1, 2, 520, 8)])
def test_corner_pool_kernel_matches_plain_exactly(cuda, direction, dtype,
                                                  shape):
    """Rays below, at and above a warp's 32 V elements (V = 8 along W, 4
    float32 or 8 bf16 columns along H), odd and vector-width sides, the
    scalar path (W not a multiple of V) and more than one pass of rows;
    random values, then ReLU'd ones (runs of tied zeros)."""
    from erd_tpu_torch.ops import corner_pool, corner_pool_plain
    base = np.random.RandomState(1).randn(*shape).astype(np.float32)
    for values in (base, np.maximum(base, 0)):
        x = torch.from_numpy(values).to(device=cuda, dtype=dtype)
        before = corner_pool.launches
        got = corner_pool(x, direction)
        torch.cuda.synchronize()
        assert corner_pool.launches - before == 1
        assert got.dtype == dtype
        assert torch.equal(got, corner_pool_plain(x, direction))


def same_with_nan(a, b):
    """Equal values, NaN where the other has NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan()))
                                       .all())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(1, 1, 6, 6), (2, 3, 37, 19),
                                   (1, 4, 192, 256), (1, 2, 300, 257)])
def test_corner_pool_kernels_carry_nan_as_plain(cuda, dtype, shape):
    """Fault 3.11 on the card: the forward kernel carries a NaN along the
    ray as torch.cummax does, and the backward kernel sends no gradient
    through a combine whose output is NaN, as the plain version (JAX's
    _balanced_eq rule) does; every direction, the CPU tests' repro ray
    among the rays."""
    from erd_tpu_torch.ops import corner_pool, corner_pool_plain
    from erd_tpu_torch.ops.extra_nms import (corner_pool_backward,
                                             corner_pool_backward_plain)
    rs = np.random.RandomState(9)
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    x[rs.rand(*shape) < 0.03] = np.nan
    x[0, 0, :, 0] = np.nan
    x[0, 0, :6, -1] = [1, np.nan, 0.5, 2, 2, 0]
    x[0, 0, -1, :6] = [1, np.nan, 0.5, 2, 2, 0]
    x = torch.from_numpy(x).to(device=cuda, dtype=dtype)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        device=cuda, dtype=dtype)
    for direction in ('top', 'bottom', 'left', 'right'):
        got = corner_pool(x, direction)
        torch.cuda.synchronize()
        want = corner_pool_plain(x, direction)
        assert bool(want.isnan().any()) and same_with_nan(got, want)
        gx = corner_pool_backward(x, g, direction)
        torch.cuda.synchronize()
        gw = corner_pool_backward_plain(x, g, direction)
        assert bool(gw.isfinite().all()) and torch.equal(gx, gw)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(1, 128, 24, 40), (2, 3, 37, 19),
                                   (1, 8, 1, 33), (2, 64, 33, 1),
                                   (1, 33, 31, 257), (1, 1, 300, 5),
                                   (2, 40, 65, 9), (1, 128, 192, 256)])
def test_corner_pool_kernel_takes_channels_last_maps(cuda, dtype, shape):
    """A channels-last map (the hourglass's layout on the card) is read
    where it lies (erd_corner_pool_nhwc: tiles of 32 channels, 8 rays and
    32 elements a pass, each cut ragged here): one launch, an NCHW output
    equal to plain NaN for NaN (ReLU'd values with NaNs planted), every
    direction."""
    from erd_tpu_torch.ops import corner_pool, corner_pool_plain
    rs = np.random.RandomState(8)
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    x[rs.rand(*shape) < 0.02] = np.nan
    x = torch.from_numpy(x).to(device=cuda, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    for direction in ('top', 'bottom', 'left', 'right'):
        before = corner_pool.launches
        got = corner_pool(x, direction)
        torch.cuda.synchronize()
        assert corner_pool.launches - before == 1
        assert got.is_contiguous()
        assert same_with_nan(got, corner_pool_plain(x, direction))


def test_corner_pool_kernel_takes_rows_off_16_bytes(cuda):
    """A contiguous map whose data starts 4 bytes past a 16-byte boundary
    takes the scalar path, equal to plain."""
    from erd_tpu_torch.ops import corner_pool, corner_pool_plain
    shape = (1, 3, 40, 64)
    flat = torch.randn(int(np.prod(shape)) + 1, device=cuda)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    for direction in ('top', 'bottom', 'left', 'right'):
        got = corner_pool(x, direction)
        torch.cuda.synchronize()
        assert torch.equal(got, corner_pool_plain(x, direction))


def test_point_sample_and_corner_pool_never_reach_plain_on_cuda(
        cuda, monkeypatch):
    """CUDA tensors launch the kernels, forward and backward, or raise:
    align_corners=True has no kernel, and points take no gradient."""
    import erd_tpu_torch.ops.extra_nms as pool_module
    import erd_tpu_torch.ops.sampling as sampling_module

    def refuse(*args):
        raise AssertionError('the plain version ran on a CUDA tensor')
    for name in ('point_sample_plain', 'point_sample_backward_plain'):
        monkeypatch.setattr(sampling_module, name, refuse)
    for name in ('corner_pool_plain', 'corner_pool_backward_plain'):
        monkeypatch.setattr(pool_module, name, refuse)
    maps, pts = point_sample_case(np.random.RandomState(2), cuda,
                                  torch.float32, 'fine')
    sampling_module.point_sample(maps, pts)
    pool_module.corner_pool(maps, 'left')
    for form in ('uncertainty', 'coarse', 'fine', 'targets'):
        m, p = point_train_case(np.random.RandomState(3), cuda, form)
        for plan in point_forced_plans(m, p.shape[1]).values():
            sampling_module.point_sample_launch(m, p, plan)
    with pytest.raises(NotImplementedError, match='align_corners'):
        sampling_module.point_sample(maps, pts, align_corners=True)
    with pytest.raises(ValueError, match='no gradient'):
        sampling_module.point_sample(maps, pts.clone().requires_grad_())
    counts = (sampling_module.point_sample_backward.launches,
              pool_module.corner_pool_backward.launches)
    leaf = maps.clone().requires_grad_()
    (sampling_module.point_sample(leaf, pts).sum() +
     pool_module.corner_pool(leaf, 'top').sum()).backward()
    torch.cuda.synchronize()
    assert (sampling_module.point_sample_backward.launches - counts[0],
            pool_module.corner_pool_backward.launches - counts[1]) == (1, 1)
    assert leaf.grad.shape == maps.shape and bool(leaf.grad.isfinite().all())


def test_point_sample_backward_kernel_matches_plain(cuda):
    """The backward kernel on both PointRend call forms with gradients:
    coarse float32 channels-last logits (float32 sums within 1e-5 *
    max|plain|; the plain version's CUDA atomics reorder its sums) and a
    bf16 P2 (rounded once, within
    one bf16 ulp of the rounded plain sums); the buffer keeps the map's
    strides."""
    from erd_tpu_torch.ops.sampling import (point_sample_backward,
                                            point_sample_backward_plain)
    rs = np.random.RandomState(5)
    for form, dtype in (('coarse', torch.float32), ('fine', torch.bfloat16),
                        ('fine', torch.float32)):
        maps, pts = point_sample_case(rs, cuda, dtype, form)
        if form == 'fine':
            maps = maps.contiguous(memory_format=torch.channels_last)
        g = torch.randn((*pts.shape[:2], maps.shape[1]), device=cuda)
        before = point_sample_backward.launches
        got = point_sample_backward(g, pts, tuple(maps.shape), maps.stride(),
                                    dtype)
        torch.cuda.synchronize()
        assert point_sample_backward.launches - before == 1
        assert got.dtype == dtype and got.stride() == maps.stride()
        want = point_sample_backward_plain(g, pts, tuple(maps.shape))
        diff = (got.float() - want).abs()
        limit = 1e-5 * float(want.abs().max())
        if dtype == torch.float32:
            assert float(diff.max()) <= limit, (form, float(diff.max()))
        else:
            assert bool(((bf16_ulps(got, want.to(dtype)) <= 1) |
                         (diff <= limit)).all())


def point_backward_case(rs, device, form, layout):
    """One PointRend call form with planted edge cases: points exactly on
    0 and 1 (corners on the map's edge) and off the map, 500 points on one
    pixel (its list of corners the longest), and a map whose points all lie
    off it (its gradient all zeros); the gradient (N, K, C), the points and
    the maps' shape and strides (channels-last or NCHW)."""
    maps, pts = point_sample_case(rs, device, torch.float32, form)
    pts = pts.clone()
    pts[0, 4:8] = torch.tensor([[0., 0.5], [1., 0.5], [0.5, 0.], [0.5, 1.]])
    pts[0, 8:12] = torch.tensor([[-0.3, 0.5], [1.3, 0.5], [0.5, -2.],
                                 [5., 5.]])
    pts[1, :] = torch.tensor([1.5, -0.5])
    many = min(500, pts.shape[1] - 20)
    pts[0, 20:20 + many] = torch.tensor([0.3, 0.6])
    if layout == 'channels_last':
        maps = maps.contiguous(memory_format=torch.channels_last)
    else:
        maps = maps.contiguous()
    g = torch.from_numpy(rs.randn(*pts.shape[:2], maps.shape[1]).astype(
        np.float32)).to(device)
    return g, pts, tuple(maps.shape), maps.stride()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', ['channels_last', 'nchw'])
@pytest.mark.parametrize('form', ['coarse', 'fine'])
def test_point_sample_backward_kernel_edges_layouts_and_repeats(cuda, form,
                                                                layout,
                                                                dtype):
    """Both call forms in channels-last and NCHW strides, with edge
    points, 500 points on one pixel (176 on a coarse map) and a map with no
    valid point: the result keeps the maps' strides, the map without points
    is all zeros, float32 within 1e-5 * max|plain| and bf16 within one ulp
    (or 1e-5 * max|plain|) of the plain version, on the card and on the
    CPU; two calls are equal (the kernel sums in a fixed order)."""
    from erd_tpu_torch.ops.sampling import (point_sample_backward,
                                            point_sample_backward_plain)
    g, pts, shape, strides = point_backward_case(
        np.random.RandomState(7), cuda, form, layout)
    before = point_sample_backward.launches
    got = point_sample_backward(g, pts, shape, strides, dtype)
    torch.cuda.synchronize()
    assert point_sample_backward.launches - before == 1
    assert got.dtype == dtype and got.stride() == strides
    assert not bool(got[1].any())
    for want in (point_sample_backward_plain(g, pts, shape),
                 point_sample_backward_plain(g.cpu(), pts.cpu(),
                                             shape).to(cuda)):
        diff = (got.float() - want).abs()
        limit = 1e-5 * float(want.abs().max())
        if dtype == torch.float32:
            assert float(diff.max()) <= limit
        else:
            assert bool(((bf16_ulps(got, want.to(dtype)) <= 1) |
                         (diff <= limit)).all())
    assert torch.equal(point_sample_backward(g, pts, shape, strides, dtype),
                       got)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c,h,w', [(13, 720, 800), (300, 40, 60)])
def test_point_sample_backward_kernel_large_maps_and_channel_groups(
        cuda, dtype, c, h, w):
    """Maps the gather bins by 8 x 8 tiles: 720 x 800 has 9000 tiles, more
    than the binning keeps in shared memory (its counts in global memory),
    with 13 channels (no four-channel stores); 300 channels take two
    channel groups. Points clustered on a few spots and spread over the
    map, some off it: float32 within 1e-5 * max|plain|, bf16 within one
    ulp, two calls equal."""
    from erd_tpu_torch.ops.sampling import (point_sample_backward,
                                            point_sample_backward_plain)
    rs = np.random.RandomState(c)
    n, k = 2, 3000
    pts = rs.uniform(-0.05, 1.05, (n, k, 2)).astype(np.float32)
    pts[:, :1000] = rs.uniform(0.3, 0.31, (n, 1000, 2))
    pts = torch.from_numpy(pts).to(cuda)
    g = torch.from_numpy(rs.randn(n, k, c).astype(np.float32)).to(cuda)
    shape = (n, c, h, w)
    strides = torch.empty(shape, device='meta').contiguous(
        memory_format=torch.channels_last).stride()
    got = point_sample_backward(g, pts, shape, strides, dtype)
    torch.cuda.synchronize()
    assert got.stride() == strides and got.dtype == dtype
    want = point_sample_backward_plain(g, pts, shape)
    diff = (got.float() - want).abs()
    limit = 1e-5 * float(want.abs().max())
    if dtype == torch.float32:
        assert float(diff.max()) <= limit
    else:
        assert bool(((bf16_ulps(got, want.to(dtype)) <= 1) |
                     (diff <= limit)).all())
    assert torch.equal(point_sample_backward(g, pts, shape, strides, dtype),
                       got)


@pytest.mark.parametrize('direction', ['top', 'bottom', 'left', 'right'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(1, 128, 192, 256), (2, 3, 37, 19),
                                   (1, 2, 1, 5), (1, 2, 8, 8)])
def test_corner_pool_backward_kernel_matches_plain_exactly(cuda, direction,
                                                           dtype, shape):
    """The scan-tree backward on random maps with ReLU'd ties (a third of
    the values 0, runs of equal values): bit-equal to the plain version's
    autograd through the same recursion, odd and even ray lengths."""
    from erd_tpu_torch.ops.extra_nms import (corner_pool_backward,
                                             corner_pool_backward_plain)
    rs = np.random.RandomState(6)
    x = np.maximum(rs.randn(*shape), -0.4) + 0.4
    x[..., ::3] = np.round(x[..., ::3] * 2) / 2
    x = torch.from_numpy(x.astype(np.float32)).to(device=cuda, dtype=dtype)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        device=cuda, dtype=dtype)
    before = corner_pool_backward.launches
    got = corner_pool_backward(x, g, direction)
    torch.cuda.synchronize()
    assert corner_pool_backward.launches - before == 1
    assert got.dtype == dtype
    assert torch.equal(got, corner_pool_backward_plain(x, g, direction))


@pytest.mark.parametrize('direction', ['top', 'bottom', 'left', 'right'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layouts', [('channels_last', 'nchw'),
                                     ('channels_last', 'channels_last'),
                                     ('nchw', 'channels_last')])
@pytest.mark.parametrize('shape', [(1, 128, 192, 256), (2, 3, 37, 19),
                                   (1, 40, 9, 300), (1, 9, 512, 6)])
def test_corner_pool_backward_kernel_reads_channels_last(cuda, direction,
                                                         dtype, layouts,
                                                         shape):
    """x and the output gradient channels-last or NCHW, read where they lie
    (the CornerNet step's x is channels-last, its gradient NCHW): one
    launch, bit-equal to plain, the result in x's layout (x's strides);
    rays of 300 and 512 take 16 leaves a lane."""
    from erd_tpu_torch.ops.extra_nms import (corner_pool_backward,
                                             corner_pool_backward_plain)
    rs = np.random.RandomState(12)
    x = np.maximum(rs.randn(*shape), -0.4) + 0.4
    x[..., ::3] = np.round(x[..., ::3] * 2) / 2
    x = torch.from_numpy(x.astype(np.float32)).to(device=cuda, dtype=dtype)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        device=cuda, dtype=dtype)

    def laid(t, layout):
        return t.contiguous(memory_format=torch.channels_last) \
            if layout == 'channels_last' else t.contiguous()
    x, g = laid(x, layouts[0]), laid(g, layouts[1])
    before = corner_pool_backward.launches
    got = corner_pool_backward(x, g, direction)
    torch.cuda.synchronize()
    assert corner_pool_backward.launches - before == 1
    assert got.dtype == dtype and got.stride() == x.stride()
    assert torch.equal(got, corner_pool_backward_plain(x, g, direction))


def test_corner_pool_backward_kernel_refuses_rays_above_512(cuda):
    from erd_tpu_torch.ops.extra_nms import corner_pool_backward
    x = torch.zeros((1, 2, 4, 513), device=cuda)
    with pytest.raises(ValueError, match='at most 512'):
        corner_pool_backward(x, x, 'left')
    corner_pool_backward(x, x, 'top')  # rays of 4 along H


@pytest.mark.parametrize('out_size', [28, 14])
def test_crop_resize_mask_kernel_matches_plain_exactly(cuda, out_size):
    """Mask targets of 512 RoIs an image, some outside or beyond their gt
    box, degenerate gt boxes among them: equal to the plain version."""
    from erd_tpu_torch.data.masks import (crop_resize_mask,
                                          crop_resize_mask_plain)
    rs = np.random.RandomState(7)
    b, g, s = 2, 16, 512
    xy = rs.uniform(0, 700, (b, g, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0, 300, (b, g, 2))], -1)
    boxes[0, 0] = [50, 50, 50, 50]
    masks = (rs.rand(b, g, 56, 56) < 0.5).astype(np.uint8)
    idx = rs.randint(0, g, (b, s))
    gt_xy = boxes[np.arange(b)[:, None], idx, :2]
    rois = np.concatenate([gt_xy - 40 + rs.uniform(0, 80, (b, s, 2))] * 2,
                          -1)
    rois[..., 2:] += rs.uniform(0, 400, (b, s, 2))
    args = [torch.from_numpy(a).to(cuda) for a in (
        masks, boxes.astype(np.float32), idx, rois.astype(np.float32))]
    before = crop_resize_mask.launches
    got = crop_resize_mask(*args, out_size)
    torch.cuda.synchronize()
    assert crop_resize_mask.launches - before == 1
    want = crop_resize_mask_plain(*args, out_size)
    assert torch.equal(got, want)
    assert 0.05 < float((want > 0).float().mean()) < 0.95


def test_crop_resize_mask_never_reaches_plain_on_cuda(cuda, monkeypatch):
    """CUDA tensors launch the mask-target kernel (one launch, whatever
    the index type) and never the plain version."""
    import erd_tpu_torch.data.masks as masks_module

    def refuse(*args):
        raise AssertionError('the plain version ran on a CUDA tensor')
    monkeypatch.setattr(masks_module, 'crop_resize_mask_plain', refuse)
    masks = torch.zeros((2, 3, 56, 56), dtype=torch.uint8, device=cuda)
    boxes = torch.tensor([[0., 0., 10., 10.]] * 6, device=cuda).view(2, 3, 4)
    rois = torch.tensor([[1., 1., 5., 5.]] * 10, device=cuda).view(2, 5, 4)
    for index in (torch.int64, torch.int32, torch.int16):
        idx = torch.zeros((2, 5), dtype=index, device=cuda)
        before = masks_module.crop_resize_mask.launches
        out = masks_module.crop_resize_mask(masks, boxes, idx, rois, 14)
        torch.cuda.synchronize()
        assert masks_module.crop_resize_mask.launches - before == 1
        assert out.shape == (2, 5, 14, 14) and not bool(out.any())


@pytest.mark.parametrize('out_size', [28, 14, 7])
@pytest.mark.parametrize('s', [1, 13, 37])
def test_crop_resize_mask_kernel_ragged_runs_and_index_types(cuda, out_size,
                                                            s):
    """Runs of RoIs that end inside a warp's run or a block's (a warp takes
    1 RoI at 28 and 3 at 14 and 7, a block 8 warps), an out^2 that is not
    a multiple of 4 (7: a cell a lane at a time, the size read at run
    time), RoIs far off their gt and on it, degenerate gt boxes; int64 and
    int32 gt indices read in place, both equal to plain."""
    from erd_tpu_torch.data.masks import (crop_resize_mask,
                                          crop_resize_mask_plain)
    rs = np.random.RandomState(8)
    b, g = 3, 4
    xy = rs.uniform(0, 300, (b, g, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0, 200, (b, g, 2))], -1)
    boxes[0, 1] = [20, 20, 20, 20]
    boxes[1, 2] = [10, 40, 80, 40.0005]
    masks = (rs.rand(b, g, 56, 56) < 0.5).astype(np.uint8)
    idx = rs.randint(0, g, (b, s))
    gt_xy = boxes[np.arange(b)[:, None], idx, :2]
    rois = np.concatenate([gt_xy - 30 + rs.uniform(0, 60, (b, s, 2))] * 2,
                          -1)
    rois[..., 2:] += rs.uniform(0, 250, (b, s, 2))
    rois[0, 0] = [-1e5, -1e5, -9e4, -9e4]
    rois[-1, -1] = [1e5, 1e5, 2e5, 2e5]
    for index in (torch.int64, torch.int32):
        args = [torch.from_numpy(a).to(cuda) for a in (
            masks, boxes.astype(np.float32), idx, rois.astype(np.float32))]
        args[2] = args[2].to(index)
        got = crop_resize_mask(*args, out_size)
        torch.cuda.synchronize()
        assert torch.equal(got, crop_resize_mask_plain(*args, out_size))


def test_render_corner_targets_kernel_matches_plain(cuda):
    """Corner targets of a batch of 6 images at 192x256, 80 classes, 16 gt
    slots (some invalid, two sharing a corner pixel): heat within 1e-6,
    the exact-1 peaks, offsets, weights and corner pixels equal."""
    from erd_tpu_torch.ops.gaussian import (corner_scalars,
                                            render_corner_targets,
                                            render_corner_targets_plain)
    rs = np.random.RandomState(8)
    b, g = 6, 16
    xy = rs.uniform(0, 900, (b, g, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(8, 500, (b, g, 2))], -1)
    boxes[0, 1] = boxes[0, 0] + [1, 1, -1, -1]
    labels = rs.randint(0, 80, (b, g))
    valid = rs.rand(b, g) < 0.8
    args = [torch.from_numpy(a).to(cuda) for a in (
        boxes.astype(np.float32), labels, valid)]
    ratio = (256 / 1024, 192 / 768)
    before = render_corner_targets.launches
    got = render_corner_targets(*args, (192, 256), 80, ratio)
    torch.cuda.synchronize()
    assert render_corner_targets.launches - before == 1
    want = render_corner_targets_plain(
        corner_scalars(*args, (192, 256), 80, ratio), (192, 256), 80)
    for c in ('tl', 'br'):
        assert float((got[f'{c}_heat'] - want[f'{c}_heat']).abs().max()) \
            <= 1e-6
        assert int((got[f'{c}_heat'] == 1).sum()) == \
            int((want[f'{c}_heat'] == 1).sum()) > 0
        for k in ('off', 'w'):
            assert torch.equal(got[f'{c}_{k}'], want[f'{c}_{k}'])


@pytest.mark.parametrize('kind', ['mask_rcnn', 'point_rend'])
def test_mask_serving_on_cuda_uses_kernels(cuda, kind):
    """bf16 ResNet-18 Mask R-CNN or PointRend on the card at a small
    canvas: per request 2 NMS and 2 RoIAlign launches (+ 4 point_sample
    for PointRend); masks in [0, 1] of 28x28 or 56x56."""
    from erd_tpu_torch.ops import point_sample
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs', {
            'mask_rcnn': 'mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py',
            'point_rend': 'point_rend/point-rend_r50-caffe_fpn_ms-1x_coco.py'
        }[kind])
    cfg = Config.fromfile(path)
    cfg.model.depth = 18
    det, net, _ = init_detector(cfg, device=cuda)
    fns = (nms_sorted_keep, roi_align, point_sample)
    img = np.random.RandomState(3).randint(0, 256, (256, 320, 3), np.uint8)
    counts = [f.launches for f in fns]
    res = inference_detector(det, net, img, scale=(320, 256))
    got = [f.launches - c for f, c in zip(fns, counts)]
    assert got == [2, 2, 4 if kind == 'point_rend' else 0]
    assert np.isfinite(res.bboxes).all()
    rec = ImageRecord(0, '', 320, 256, np.zeros((0, 4), np.float32),
                      np.zeros((0,), np.int32), np.zeros((0,), bool))
    canvas, _, meta = DetPipeline(scale=(320, 256))(rec, image=img)
    _, masks = det.predict(net, dict(
        images=torch.from_numpy(canvas[None]).to(cuda),
        meta=stack_to([meta], cuda)))
    assert masks.shape[2:] == ((56, 56) if kind == 'point_rend' else
                               (28, 28))
    assert bool(((masks >= 0) & (masks <= 1)).all())


def test_cornernet_serving_on_cuda_uses_kernels(cuda):
    """A small float32 CornerNet on the card: 4 corner_pool launches (the
    last stack's) and 1 soft-NMS launch a request; the same network
    outputs decoded on the card and on the CPU agree."""
    from erd_tpu_torch.models import CornerNetDetector
    from erd_tpu_torch.ops import corner_pool
    det = CornerNetDetector(num_classes=4, stage_channels=(16, 16, 24),
                            stage_blocks=(1, 1, 1), downsample_times=2,
                            corner_topk=20)
    net = det.init(seed=0, device=cuda)
    img = np.random.RandomState(4).randint(0, 256, (90, 120, 3), np.uint8)
    counts = (corner_pool.launches, soft_nms.launches)
    res = inference_detector(det, net, img, scale=(128, 96))
    assert (corner_pool.launches - counts[0],
            soft_nms.launches - counts[1]) == (4, 1)
    assert np.isfinite(res.bboxes).all()
    rec = ImageRecord(0, '', 120, 90, np.zeros((0, 4), np.float32),
                      np.zeros((0,), np.int32), np.zeros((0,), bool))
    canvas, _, meta = DetPipeline(scale=(128, 96))(rec, image=img)
    with torch.no_grad():
        out = net.last_stack(det.preprocessor(
            torch.from_numpy(canvas[None]).to(cuda)))
    # on a 1/64 grid: equal outputs tie on both devices, and the sigmoids'
    # last-bit differences cannot reorder the corners
    out = {k: torch.round(v * 64) / 64 for k, v in out.items()}
    got = det.nms(*det.decode(out, canvas.shape[:2], stack_to([meta], cuda)))
    want = det.nms(*det.decode({k: v.cpu() for k, v in out.items()},
                               canvas.shape[:2], stack_to([meta], 'cpu')))
    assert torch.equal(got.mask.cpu(), want.mask)
    assert torch.equal(got.labels.cpu(), want.labels)
    torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(got.bboxes.cpu(), want.bboxes, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize('kind', ['mask_rcnn', 'point_rend', 'cornernet'])
def test_mask_and_corner_training_on_cuda_uses_kernels(cuda, kind):
    """Two fit steps on the card (ResNet-18 bf16 Mask R-CNN / PointRend at
    256x320 with gt masks, or the small float32 CornerNet at 128x256):
    finite losses, the launches of every new kernel each step (the mask
    targets, the point-sample backward twice, the corner-pool backward 8
    times, the corner targets), every trainable weight moved."""
    from erd_tpu_torch.apis import build_trainer
    from erd_tpu_torch.data.masks import crop_resize_mask
    from erd_tpu_torch.engine import Hook
    from erd_tpu_torch.models import CornerNetDetector
    from erd_tpu_torch.ops import corner_pool, point_sample
    from erd_tpu_torch.ops.extra_nms import corner_pool_backward
    from erd_tpu_torch.ops.gaussian import render_corner_targets
    from erd_tpu_torch.ops.sampling import point_sample_backward
    from erd_tpu_torch.structures import ImageMeta
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rs = np.random.RandomState(9)
    boxes = np.array([[20, 30, 120, 150], [150, 40, 300, 200]], np.float32)
    masks = [(rs.rand(56, 56) < 0.6).astype(np.uint8) for _ in range(2)]
    if kind == 'cornernet':
        cfg = Config.fromfile(os.path.join(
            root, 'configs', 'cornernet',
            'cornernet_hourglass104_8xb6-210e-mstest_coco.py'))
        det = CornerNetDetector(num_classes=4, stage_channels=(16, 16, 24),
                                stage_blocks=(1, 1, 1), downsample_times=2)
        hw = (128, 256)
    else:
        cfg = Config.fromfile(os.path.join(root, 'configs', {
            'mask_rcnn': 'mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py',
            'point_rend': 'point_rend/point-rend_r50-caffe_fpn_ms-1x_coco.py'
        }[kind]))
        cfg.model.depth = 18
        det = build_detector(cfg.model)
        hw = (256, 320)
    cfg.train_cfg.epochs = 1
    net = det.init(seed=0, device=cuda)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    batch = dict(
        images=torch.from_numpy(rs.randint(0, 256, (2, *hw, 3),
                                           np.uint8)).to(cuda),
        gt=stack_to([GTInstances.pad(boxes, [0, 1], 4, masks=masks)] * 2,
                    cuda),
        meta=stack_to([ImageMeta.make(hw, hw, (1.0, 1.0), img_id=i)
                       for i in range(2)], cuda))

    class Loader:
        cfg = type('LoaderConfig', (), {'batch_size': 2})()

        def steps_per_epoch(self, epoch):
            return 2

        def epoch(self, epoch):
            yield batch
            yield batch

    class Record(Hook):
        def after_iter(self, trainer, step, step_losses):
            losses.append(step_losses)
    fns = (crop_resize_mask, point_sample, point_sample_backward,
           corner_pool, corner_pool_backward, render_corner_targets)
    counts = [f.launches for f in fns]
    losses = []
    trainer = build_trainer(cfg, det, Loader(), device=cuda)
    trainer.hooks.append(Record())
    trainer.fit(net)
    got = [f.launches - c for f, c in zip(fns, counts)]
    want = {'mask_rcnn': [2, 0, 0, 0, 0, 0],
            'point_rend': [2, 8, 4, 0, 0, 0],
            'cornernet': [0, 0, 0, 16, 16, 2]}[kind]
    assert got == want, got
    assert all(np.isfinite(v) for step in losses for v in step.values())
    trainable = {k for k, p in net.named_parameters() if p.requires_grad}
    for k, v in net.state_dict().items():
        if k in trainable and v.dim() > 1:
            assert not torch.equal(v, start[k]), k


def extra_nms_case(rs, n, num_labels):
    """Clustered boxes over many labels on a 1/4-pixel grid, exact
    duplicates (tied IoUs), scores on a 1/16 grid (ties), 10 % invalid."""
    centres = rs.uniform(50, 1300, (8, 2))
    c = centres[rs.randint(8, size=n)] + rs.normal(0, 12, (n, 2))
    wh = rs.uniform(16, 120, (n, 2))
    boxes = np.round(np.concatenate([c - wh / 2, c + wh / 2], -1) * 4) / 4
    dup = rs.rand(n) < 0.1
    boxes[dup] = boxes[rs.randint(n, size=int(dup.sum()))]
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy((rs.randint(0, 16, n) / 16).astype(np.float32)),
            torch.from_numpy(rs.randint(0, num_labels, n)),
            torch.from_numpy(rs.rand(n) > 0.1))


def test_extra_nms_kernels_match_plain(cuda):
    """Matrix NMS (box form at K = 2000 and SOLOv2's mask-IoU form at N =
    500: on the IoU, and fused with the IoU from inter and area) within
    1e-6 relative of the plain versions, zeros equal; fast NMS and
    nms_match at K = 2000, 80 classes, exactly; two counted launches per
    matrix NMS call on boxes or an IoU (comp, then the decay), one per
    fused call and fast NMS call (from the unsorted inputs), row 1's call
    and one leader launch per nms_match call."""
    from erd_tpu_torch.ops import (fast_nms, mask_matrix_decay,
                                   mask_matrix_decay_plain, matrix_decay,
                                   matrix_decay_plain, matrix_nms,
                                   matrix_nms_plain, nms_match)
    rs = np.random.RandomState(21)
    cases = [extra_nms_case(rs, 2000, 80) for _ in range(2)]
    boxes, scores, labels, valid = (torch.stack(t) for t in zip(*cases))
    for kernel in ('gaussian', 'linear'):
        before = matrix_nms.launches
        got = matrix_nms(boxes.to(cuda), scores.to(cuda), labels.to(cuda),
                         valid.to(cuda), kernel=kernel)
        torch.cuda.synchronize()
        assert matrix_nms.launches == before + 2
        want = matrix_nms_plain(boxes, scores, labels, valid, kernel=kernel)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-6, atol=0)
    masks = torch.from_numpy(rs.rand(2, 500, 40, 50) < 0.3).float()
    masks[:, 250:] = 0
    inter = masks.flatten(2) @ masks.flatten(2).transpose(1, 2)
    area = masks.flatten(2).sum(-1)
    miou = inter / (area[:, :, None] + area[:, None, :] - inter).clamp(min=1)
    s = scores[:, :500].clone()
    s[:, 300:] = 0
    before = matrix_decay.launches
    got = matrix_decay(s.to(cuda), miou.to(cuda), labels[:, :500].to(cuda))
    torch.cuda.synchronize()
    assert matrix_decay.launches == before + 2
    np.testing.assert_allclose(
        got.cpu().numpy(),
        matrix_decay_plain(s, miou, labels[:, :500]).numpy(), rtol=1e-6,
        atol=0)
    before = mask_matrix_decay.launches
    fused = mask_matrix_decay(s.to(cuda), inter.to(cuda), area.to(cuda),
                              labels[:, :500].to(cuda))
    torch.cuda.synchronize()
    assert mask_matrix_decay.launches == before + 1
    want = mask_matrix_decay_plain(s, inter, area, labels[:, :500])
    assert torch.equal(fused.cpu() == 0, want == 0)
    np.testing.assert_allclose(fused.cpu().numpy(), want.numpy(), rtol=1e-6,
                               atol=0)
    before = fast_nms.launches
    got = fast_nms(boxes.to(cuda), scores.to(cuda), labels.to(cuda), 0.5,
                   valid.to(cuda))
    assert fast_nms.launches == before + 1
    want = fast_nms(boxes, scores, labels, 0.5, valid)
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < want.numel()
    before = (nms_sorted_keep.launches, nms_match.launches)
    keep, leader = nms_match(boxes.to(cuda), scores.to(cuda), 0.5,
                             valid.to(cuda))
    assert (nms_sorted_keep.launches, nms_match.launches) == (
        before[0] + 1, before[1] + 1)
    want_keep, want_leader = nms_match(boxes, scores, 0.5, valid)
    assert torch.equal(keep.cpu(), want_keep)
    assert torch.equal(leader.cpu(), want_leader)


SPECIAL_SCORES = np.float32([np.nan, np.inf, -np.inf, -0.0, 0.0])
WIDE_LABELS = np.int64([2 ** 40 + 3, -7, -2 ** 62, 5, 2 ** 40 + 1027])


def nms_edge_case(seed, b, k, labels='few'):
    """(boxes, scores, labels, valid), (B, K, ...) on the CPU, as
    tests/test_torch_fastnms_match.py's edge cases: boxes around two
    centres with duplicates and zero-area boxes, 1/8-grid scores of which
    ~30 % are NaN, +inf, -inf, -0 or +0, ~15 % invalid; 3 classes, one
    class, or large and negative int64 labels equal modulo 1024 in
    pairs."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(30, 60, (b, 2, 2))[np.arange(b)[:, None],
                                      rs.randint(2, size=(b, k))] + \
        rs.normal(0, 6, (b, k, 2))
    wh = rs.uniform(4, 30, (b, k, 2))
    boxes = np.round(np.concatenate([c - wh / 2, c + wh / 2], -1) * 4) / 4
    dup = rs.rand(b, k) < 0.15
    boxes[dup] = boxes.reshape(-1, 4)[rs.randint(b * k,
                                                 size=int(dup.sum()))]
    flat = rs.rand(b, k) < 0.08
    boxes[flat, 2] = boxes[flat, 0]
    scores = (rs.randint(0, 8, (b, k)) / 8).astype(np.float32)
    odd = rs.rand(b, k) < 0.3
    scores[odd] = SPECIAL_SCORES[rs.randint(5, size=int(odd.sum()))]
    lab = {'few': rs.randint(0, 3, (b, k)),
           'one': np.zeros((b, k), np.int64),
           'wide': WIDE_LABELS[rs.randint(5, size=(b, k))]}[labels]
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores), torch.from_numpy(lab.astype(np.int64)),
            torch.from_numpy(rs.rand(b, k) > 0.15))


@pytest.mark.parametrize('seed,b,k,labels,thr', [
    (0, 1, 37, 'few', 0.5), (1, 2, 37, 'one', 0.5), (2, 1, 37, 'wide', 0.5),
    (3, 2, 100, 'few', 1.0), (4, 1, 100, 'one', 0.3), (5, 2, 130, 'few', 1.5),
    (6, 1, 1, 'few', 0.5), (7, 2, 700, 'wide', 0.3), (8, 1, 3000, 'one', 0.5),
    (9, 3, 2100, 'few', 0.0)])
@pytest.mark.parametrize('masked', [False, True])
def test_fast_nms_and_nms_match_kernels_on_edge_cases(cuda, seed, b, k,
                                                      labels, thr, masked):
    """fast NMS (int64 and int32 labels) and nms_match on the card against
    their plain versions on the CPU, exactly, on the edge cases of the
    kernels' rules (tests/test_torch_fastnms_match.py holds the plain
    versions to erd_tpu on them): one fast-NMS launch a call; nms_match
    row 1's call and one leader launch."""
    from erd_tpu_torch.ops import fast_nms, nms_match
    boxes, scores, lab, valid = nms_edge_case(seed, b, k, labels)
    valid = valid if masked else None
    dev = [t.to(cuda) for t in (boxes, scores, lab)]
    dvalid = None if valid is None else valid.to(cuda)
    want = fast_nms(boxes, scores, lab, thr, valid)
    for wide in (True, False):
        before = fast_nms.launches
        got = fast_nms(dev[0], dev[1], dev[2] if wide else dev[2].int(), thr,
                       dvalid)
        assert fast_nms.launches == before + 1
        assert torch.equal(got.cpu(), want), wide
    before = (nms_sorted_keep.launches, nms_match.launches)
    keep, leader = nms_match(dev[0], dev[1], thr, dvalid)
    assert (nms_sorted_keep.launches, nms_match.launches) == (
        before[0] + 1, before[1] + 1)
    want_keep, want_leader = nms_match(boxes, scores, thr, valid)
    assert torch.equal(keep.cpu(), want_keep)
    assert torch.equal(leader.cpu(), want_leader)


def test_fast_nms_kernel_at_its_shared_memory_limit(cuda):
    """At FAST_NMS_MAX_K boxes an image (its buckets, warp sums, members
    and boxes' buckets fill all but a few bytes of a block's 227 KB) fast
    NMS is one launch and equal to plain, class by class (a class's boxes
    keep their order and see no other class; the whole (K, K) plain call
    would take ~50 GB); one box more raises ValueError before any
    launch."""
    from erd_tpu_torch.ops import fast_nms, fast_nms_plain
    from erd_tpu_torch.ops.extra_nms import (FAST_NMS_MAX_K,
                                             MAX_BLOCK_SHARED, fast_nms_smem)
    k = FAST_NMS_MAX_K
    assert fast_nms_smem(k) <= MAX_BLOCK_SHARED < fast_nms_smem(k + 1)
    boxes, scores, labels, valid = (
        t[None].to(cuda) for t in extra_nms_case(np.random.RandomState(24),
                                                 k + 1, 80))
    before = fast_nms.launches
    got = fast_nms(boxes[:, :k], scores[:, :k], labels[:, :k], 0.5,
                   valid[:, :k])
    torch.cuda.synchronize()
    assert fast_nms.launches == before + 1
    want = torch.zeros_like(got)
    for c in labels[0, :k].unique():
        idx = torch.nonzero(labels[0, :k] == c)[:, 0]
        want[0, idx] = fast_nms_plain(boxes[:, idx], scores[:, idx],
                                      labels[:, idx], 0.5, valid[:, idx])[0]
    assert torch.equal(got, want) and 0 < int(want.sum()) < k
    with pytest.raises(ValueError, match='at most'):
        fast_nms(boxes, scores, labels, 0.5, valid)
    assert fast_nms.launches == before + 1


def test_nms_match_kernel_nan_scored_box_takes_a_later_leader(cuda):
    """A valid box scored NaN has no suppression word (row 1's sort puts it
    first): the kernel takes it the long way, to the first kept box that
    overlaps it in row 1's order, which comes later; a +inf leader gives
    -1."""
    from erd_tpu_torch.ops import nms_match
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [0, 1, 10, 11],
                          [50, 50, 60, 60], [51, 50, 61, 60],
                          [100, 100, 110, 110], [101, 101, 111, 111]],
                         dtype=torch.float32)
    scores = torch.tensor([float('nan'), 0.5, 0.25, 0.75, float('nan'),
                           float('inf'), 0.5])
    keep, leader = nms_match(boxes.to(cuda), scores.to(cuda), 0.5)
    want_keep, want_leader = nms_match(boxes, scores, 0.5)
    assert want_leader.tolist() == [1, 1, 1, 3, 3, -1, -1]
    assert torch.equal(keep.cpu(), want_keep)
    assert torch.equal(leader.cpu(), want_leader)


@pytest.mark.parametrize('k,stride,bias', [(3, 1, True), (1, 1, False),
                                           (5, 2, True), (3, 2, False)])
def test_masked_conv2d_kernel_matches_plain(cuda, k, stride, bias):
    """The masked-conv kernel against the dense IEEE float32 conv times the
    mask: masked-out positions exactly 0, the rest within 1e-5 *
    max|out| (another summation order); one launch a call."""
    from erd_tpu_torch.ops import masked_conv2d, masked_conv2d_plain
    gen = torch.Generator().manual_seed(k * 10 + stride)
    x = torch.randn(2, 64, 25, 42, generator=gen)
    w = torch.randn(48, 64, k, k, generator=gen) / (8 * k)
    b = torch.randn(48, generator=gen) if bias else None
    ho, wo = (25 - 1) // stride + 1, (42 - 1) // stride + 1
    mask = torch.rand(2, ho, wo, generator=gen) < 0.25
    before = masked_conv2d.launches
    got = masked_conv2d(x.to(cuda), mask.to(cuda), w.to(cuda),
                        None if b is None else b.to(cuda), stride)
    torch.cuda.synchronize()
    assert masked_conv2d.launches == before + 1
    want = masked_conv2d_plain(x, mask, w, b, stride)
    got = got.cpu()
    assert torch.equal(got[~mask[:, None].expand_as(got)],
                       torch.zeros(int((~mask).sum()) * 48))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize('case', ['cin3_co200', 'k3_co256', 'k5s2_co130',
                                  'k1_dense', 'empty', 'k3_co256_full',
                                  'k1_co96_full', 'k3_co256_p8300',
                                  'k3_co256_p16700'])
@pytest.mark.parametrize('tile', [1, 2, 3])
def test_masked_conv_tiles_match_plain(cuda, case, tile):
    """Each tile (128 x 128, 64 x 64, 128 x 256) against the dense IEEE
    float32 conv times the mask, ragged in P, Co and Cin K^2 (27 and 70:
    scalar weight loads), at densities 0.3-1 and 0 (no position: no launch,
    all zeros); masked-out positions exactly 0, the rest within 1e-5 *
    max|plain|, the same bits on a second call; masked_conv2d picks
    masked_conv_tile's tile, which is each of the three on some case (on
    132 SMs: 64 x 64 on the small maps, 128 x 128 on the two full 100 x 90
    maps and at 49.4 % of 100 x 168, 128 x 256 at 99.4 %: just under two
    changes of choice)."""
    from erd_tpu_torch.ops import masked_conv2d, masked_conv2d_plain
    from erd_tpu_torch.ops.sampling import (masked_conv_positions,
                                            masked_conv_tile)
    seed, b, cin, h, w, co, k, stride, density = {
        'cin3_co200': (1, 2, 3, 37, 53, 200, 3, 1, 0.3),
        'k3_co256': (2, 1, 256, 50, 84, 256, 3, 1, 0.5),
        'k5s2_co130': (3, 2, 20, 33, 41, 130, 5, 2, 0.7),
        'k1_dense': (4, 1, 70, 20, 30, 64, 1, 1, 1.0),
        'empty': (5, 1, 16, 12, 12, 24, 3, 1, 0.0),
        'k3_co256_full': (6, 2, 16, 100, 90, 256, 3, 1, 1.0),
        'k1_co96_full': (7, 2, 8, 100, 90, 96, 1, 1, 1.0),
        'k3_co256_p8300': (8, 1, 16, 100, 168, 256, 3, 1, 0.494),
        'k3_co256_p16700': (9, 1, 16, 100, 168, 256, 3, 1, 0.994)}[case]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, cin, h, w, generator=gen)
    wt = torch.randn(co, cin, k, k, generator=gen) / (cin * k * k) ** 0.5
    bias = torch.randn(co, generator=gen)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    mask = torch.rand(b, ho, wo, generator=gen) < density
    want = masked_conv2d_plain(x, mask, wt, bias, stride)
    xc, wc, bc, mc = (t.to(cuda) for t in (x, wt, bias, mask))
    flat = mc.reshape(-1)
    pos = torch.nonzero(flat).reshape(-1)
    maskv = flat[pos].float()
    before = masked_conv2d.launches
    got = masked_conv_positions(xc, wc, bc, maskv, pos, stride, (ho, wo),
                                tile)
    again = masked_conv_positions(xc, wc, bc, maskv, pos, stride, (ho, wo),
                                  tile)
    torch.cuda.synchronize()
    p = pos.numel()
    assert masked_conv2d.launches - before == (2 if p else 0)
    assert torch.equal(got, again)
    got = got.cpu()
    off = ~mask[:, None].expand_as(got)
    assert bool((got[off] == 0).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    auto = masked_conv2d(xc, mc, wc, bc, stride).cpu()
    chosen = masked_conv_tile(p, co, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    if chosen == tile:
        assert torch.equal(auto, got)


def test_solov2_serving_on_cuda_runs_the_matrix_decay_kernel(cuda):
    """SOLOv2 (ResNet-18, float32, conv_cls bias -4.5 and weights x 4,
    conv_kernel x 3) through inference_detector on the card: one
    mask_matrix_decay launch a request (the mask IoU made inside it, the
    two-launch matrix_decay not called); the card's decode of its own network
    outputs against the CPU's decode of the same outputs: labels and masks
    equal, scores within 1e-5 relative."""
    from erd_tpu_torch.ops import mask_matrix_decay, matrix_decay
    from erd_tpu_torch.structures import ImageMeta
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(root, 'configs', 'solov2',
                                       'solov2_r50_fpn_1x_coco.py'))
    cfg.model.depth = 18
    cfg.model.compute_dtype = 'float32'
    det, net, _ = init_detector(cfg, device=cuda)
    with torch.no_grad():
        head = net.mask_head
        head.conv_cls.bias.fill_(-4.5)
        head.conv_cls.weight.mul_(4.0)
        head.conv_kernel.weight.mul_(3.0)
    rs = np.random.RandomState(6)
    imgs = [rs.randint(0, 256, (240, 320, 3), np.uint8) for _ in range(2)]
    before = (mask_matrix_decay.launches, matrix_decay.launches)
    inference_detector(det, net, imgs, scale=(320, 256))
    assert (mask_matrix_decay.launches, matrix_decay.launches) == \
        (before[0] + 2, before[1])
    canvas = torch.from_numpy(np.stack([np.pad(
        i, ((0, 16), (0, 0), (0, 0))) for i in imgs])).to(cuda)
    meta = stack_to([ImageMeta.make((240, 320), (240, 320), (1.0, 1.0))] * 2,
                    cuda)
    with torch.no_grad():
        k, c, m = det.forward_raw(net, canvas)
    gpu, gcrops = det.decode(k, c, m, canvas.shape[1], meta)
    cpu, ccrops = det.decode([t.cpu() for t in k], [t.cpu() for t in c],
                             m.cpu(), canvas.shape[1],
                             stack_to([ImageMeta.make((240, 320), (240, 320),
                                                      (1.0, 1.0))] * 2,
                                      'cpu'))
    assert int(gpu.mask.sum()) > 0
    assert torch.equal(gpu.mask.cpu(), cpu.mask)
    assert torch.equal(gpu.labels.cpu(), cpu.labels)
    np.testing.assert_allclose(gpu.scores.cpu().numpy(), cpu.scores.numpy(),
                               rtol=1e-5, atol=1e-7)


# ------------------------------- the redesigned sampling forward and 7b
@pytest.mark.parametrize('heads,q,shapes', [
    (8, 300, DETR_LEVELS['landscape']),
    (1, 13, DETR_LEVELS['portrait']),
    (3, 7, [(1, 1), (5, 3), (2, 9)]),
    (8, 21, [(13, 21), (1, 1)])])
@pytest.mark.parametrize('wdtype', [torch.float32, torch.bfloat16])
def test_ms_deform_attn_kernel_is_bit_equal_to_plain(cuda, heads, q, shapes,
                                                     wdtype):
    """The float4-lane forward (4 (image, query, head) triples a warp)
    against its plain version, bit for bit: batch 2, heads 8, 3 and 1 (Q x
    heads not a multiple of 4: a ragged last warp), 1 x 1 levels, 1 to 4
    levels, locations reaching 30 % past their maps (corners off the map
    read 0), float32 and bf16 attention weights."""
    rs = np.random.RandomState(heads * 1000 + q)
    n = sum(h * w for h, w in shapes)
    levels = len(shapes)
    values = torch.from_numpy(rs.randn(2, n, heads, 32).astype(np.float32))
    locs = torch.from_numpy(rs.uniform(-0.3, 1.3, (
        2, q, heads, levels, 4, 2)).astype(np.float32))
    w = torch.from_numpy(rs.rand(2, q, heads, levels * 4).astype(
        np.float32)).softmax(-1).reshape(2, q, heads, levels, 4)
    values, locs, w = (t.to(cuda) for t in (values, locs, w.to(wdtype)))
    before = ms_deform_attn.launches
    got = ms_deform_attn(values, shapes, locs, w)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    want = ms_deform_attn_plain(values, shapes, locs, w.float())
    assert got.dtype == torch.float32 and torch.equal(got, want)


# the last 15 RoI slots of chip_smoke.py's box call (800x1344 canvas): off
# the image, on its edges or degenerate, one sized for each of levels 1-3
EDGE_ROIS = [
    [-60, -40, -2, -1], [1349, 0, 1434, 40], [-300, -200, -10, -5],
    [1354, 810, 1744, 1100], [-900, -900, -100, -100], [1444, -50, 2244, 800],
    [10, 10, 10, 10], [0, 0, 0, 0], [1336, 792, 1348, 804],
    [1340, 0, 1344, 800], [0, 796, 1344, 800], [-9, -9, 600, 500],
    [100, 100, 250, 260], [200, 100, 560, 500], [-100, -100, 900, 800]]


@pytest.mark.parametrize('out_size', [7, 14])
@pytest.mark.parametrize('c', [256, 20, 18])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_roi_align_backward_kernel_box_and_mask_calls(cuda, out_size, c,
                                                      dtype):
    """The channels-last backward at the box (out 7) and mask (out 14)
    calls' geometry: 2 images of 96 RoIs on the 800x1344 P2-P5 (every
    level reached), chip_smoke.py's 15 edge RoIs, a third of the RoIs
    with an all-zero gradient (the mask call's negatives), C = 256 and
    ragged C = 20 and 18 (18: the scratch's rows padded to 20). float32
    within 1e-5 * max|plain|; rounded to the maps' dtype, within one bf16
    ulp of plain's rounding or 1e-5 * max|plain|."""
    from erd_tpu_torch.ops import roi_align_backward, roi_align_backward_plain
    rs = np.random.RandomState(out_size * 100 + c)
    b, r = 2, 96
    xy = rs.uniform(-30, [1344, 800], (b, r, 2))
    wh = np.exp(rs.uniform(np.log(4), np.log(900), (b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, :len(EDGE_ROIS)] = EDGE_ROIS
    rois = torch.from_numpy(rois).to(cuda)
    levels = map_roi_levels(rois, 4)
    assert len(torch.unique(levels)) == 4
    grad = torch.from_numpy(rs.randn(b, r, c, out_size, out_size).astype(
        np.float32)).to(cuda)
    grad[:, 2 * len(EDGE_ROIS)::3] = 0.0
    before = roi_align_backward.launches
    got = roi_align_backward(grad, rois, levels, ROI_LEVELS, dtype=dtype,
                             out_size=out_size)
    got32 = roi_align_backward(grad, rois, levels, ROI_LEVELS,
                               out_size=out_size)
    torch.cuda.synchronize()
    assert roi_align_backward.launches == before + 2
    want = roi_align_backward_plain(grad, rois, levels, ROI_LEVELS,
                                    (4, 8, 16, 32), out_size)
    for g32, g, w in zip(got32, got, want):
        limit = 1e-5 * float(w.abs().max())
        assert g.dtype == dtype and g.shape == w.shape
        assert g.is_contiguous() and g32.dtype == torch.float32
        assert float((g32 - w).abs().max()) <= limit
        near = (g.float() - w).abs() <= limit
        if dtype == torch.bfloat16:
            assert bool(((bf16_ulps(g, w.to(dtype)) <= 1) | near).all())
        else:
            assert bool(near.all())


def test_roi_align_backward_kernel_refuses_what_its_tables_do_not_hold(cuda):
    """out_size above 32 or a sampling ratio outside 1-8 raises before a
    launch (the kernel's shared tables are sized for those)."""
    from erd_tpu_torch.ops import roi_align_backward
    rois = torch.tensor([[[4.0, 4.0, 60.0, 50.0]]], device=cuda)
    levels = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    for out_size, ratio in ((33, 2), (7, 9), (7, 0)):
        grad = torch.zeros((1, 1, 8, out_size, out_size), device=cuda)
        with pytest.raises(ValueError, match='out_size'):
            roi_align_backward(grad, rois, levels, [(20, 24)], (4,),
                               out_size=out_size, sampling_ratio=ratio)


@pytest.mark.parametrize('out_size', [7, 14])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_roi_align_kernel_at_the_training_calls(cuda, out_size, dtype):
    """The box (out 7) and mask (out 14) calls of a training step at bs 2:
    512 RoIs an image on the full-width 800x1344 P2-P5, chip_smoke.py's 15
    edge RoIs in each image, RoIs on all four levels (and elongated ones,
    whose samples spread over many pixel rows or columns). Bit-equal to
    plain, as the kernel is at every call chip_smoke.py makes."""
    rs = np.random.RandomState(out_size + 40)
    b, r = 2, 512
    feats = [torch.from_numpy(rs.randn(b, 256, h, w).astype(np.float32)).to(
        cuda).to(dtype) for h, w in ROI_LEVELS]
    xy = rs.uniform(-30, [1344, 800], (b, r, 2))
    wh = np.exp(rs.uniform(np.log(2), np.log(900), (b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, :len(EDGE_ROIS)] = EDGE_ROIS
    rois = torch.from_numpy(rois).to(cuda)
    levels = map_roi_levels(rois, 4)
    assert all(len(torch.unique(lv)) == 4 for lv in levels)
    before = roi_align.launches
    got = roi_align(feats, rois, levels, out_size=out_size)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    want = roi_align_plain(feats, rois, levels, (4, 8, 16, 32), out_size)
    assert got.shape == (b, r, 256, out_size, out_size)
    assert torch.equal(got, want)


@pytest.mark.parametrize('out_size,ratio', [(7, 1), (7, 3), (5, 4),
                                            (4, 8), (32, 1), (16, 2),
                                            (3, 5)])
def test_roi_align_kernel_other_tables(cuda, out_size, ratio):
    """Sampling ratios other than 2 (3 and 5: divides that are no power of
    two), and the largest tables the kernel holds (out_size * ratio = 32,
    a warp a bin row; ratio 8): bit-equal to plain on 96 RoIs of 2 images,
    40 channels."""
    rs = np.random.RandomState(out_size * 10 + ratio)
    b, r = 2, 96
    shapes = [(100, 168), (50, 84), (25, 42), (13, 21)]
    feats = [torch.from_numpy(rs.randn(b, 40, h, w).astype(np.float32)).to(
        cuda).to(torch.bfloat16) for h, w in shapes]
    xy = rs.uniform(-30, [672, 400], (b, r, 2))
    wh = np.exp(rs.uniform(np.log(1), np.log(600), (b, r, 2)))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32)).to(cuda)
    levels = map_roi_levels(rois, 4)
    got = roi_align(feats, rois, levels, out_size=out_size,
                    sampling_ratio=ratio)
    torch.cuda.synchronize()
    want = roi_align_plain(feats, rois, levels, (4, 8, 16, 32), out_size,
                           ratio)
    assert torch.equal(got, want)


def test_roi_align_kernel_refuses_what_its_tables_do_not_hold(cuda):
    """out_size * sampling_ratio above 32, sampling_ratio above 8, or
    either below 1, raises before a launch (the kernel's tables hold 32
    samples a side, a bin row's in one warp)."""
    feats = [torch.zeros((1, 8, 20, 24), device=cuda)]
    rois = torch.tensor([[[4.0, 4.0, 60.0, 50.0]]], device=cuda)
    levels = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    before = roi_align.launches
    for out_size, ratio in ((17, 2), (7, 5), (33, 1), (3, 9), (7, 0),
                            (0, 2)):
        with pytest.raises(ValueError, match='out_size'):
            roi_align(feats, rois, levels, (4,), out_size, ratio)
    assert roi_align.launches == before


def test_carafe_backward_kernel_is_deterministic_and_needs_no_scratch(cuda):
    """At the 100x168 call at batch 1 (bf16): two calls give the same bits
    (no atomics, sums in a fixed order), and a call allocates its two
    outputs and nothing else: the float32 weight scratch would add 6.7 MB,
    beyond the allocator's rounding of two blocks."""
    from erd_tpu_torch.ops import carafe_backward
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(1, 256, 100, 168, device=cuda, generator=gen).to(
        torch.bfloat16)
    logits = (torch.randn(1, 100, 100, 168, device=cuda, generator=gen) *
              2).to(torch.bfloat16)
    g = torch.randn(1, 256, 200, 336, device=cuda, generator=gen).to(
        torch.bfloat16)
    first = carafe_backward(x, logits, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    start = torch.cuda.memory_allocated(cuda)
    second = carafe_backward(x, logits, g)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - start
    assert grown < (x.numel() + logits.numel()) * 2 + 3 * 2 ** 20
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ----------------- the level-map decode (row 2) and the fused decay (12b)
GFL_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21), (7, 11))


def head_reg_maps(rs, cuda, dtype, layout, b=2):
    """The five (B, H, W, 68) distribution maps of an 800x1344 canvas as a
    head may leave them: NHWC views of NCHW maps (the GFL head's), NHWC
    contiguous (a channels-last network's), or NHWC at an odd element
    offset (no vector loads), float32 or bf16."""
    maps = []
    for h, w in GFL_LEVELS:
        x = torch.from_numpy((rs.randn(b, 68, h, w) * 3).astype(
            np.float32)).to(cuda).to(dtype)
        if layout == 'nchw_view':
            maps.append(x.permute(0, 2, 3, 1))
        elif layout == 'nhwc':
            maps.append(x.contiguous(memory_format=torch.channels_last)
                        .permute(0, 2, 3, 1))
        else:
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
            m = buf[1:].view(b, h, w, 68)
            m.copy_(x.permute(0, 2, 3, 1))
            maps.append(m)
    return maps


def decode_within_gate(got, want, strides, rows):
    stride = strides[rows].unsqueeze(-1)
    return bool(((got - want).abs() <= 1e-4 * stride +
                 1e-5 * want.abs()).all())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', ['nchw_view', 'nhwc', 'odd_offset'])
def test_integral_decode_reads_level_maps_in_place(cuda, dtype, layout):
    """The decode of 5000 candidate rows an image read from the five level
    maps where they lie (strided, vector and scalar loads; bf16 widened in
    registers) within 1e-4 * stride + 1e-5 * |box| px of plain, one
    counted launch."""
    from erd_tpu_torch.ops.integral import level_plan
    rs = np.random.RandomState(31)
    ctx = AnchorContext.build((800, 1344))
    centers, strides = ctx.device_tensors(cuda)
    maps = head_reg_maps(rs, cuda, dtype, layout)
    assert level_plan(maps).vec_strides == (layout != 'nchw_view')
    assert (maps[0].data_ptr() % 16 == 0) == (layout != 'odd_offset')
    rows = torch.from_numpy(rs.randint(0, ctx.num_anchors, (2, 5000))).to(
        cuda)
    shape = torch.tensor([[800.0, 1333.0], [750.0, 1000.0]], device=cuda)
    before = integral_decode.launches
    got = integral_decode(maps, rows, centers, strides, shape)
    torch.cuda.synchronize()
    assert integral_decode.launches == before + 1
    want = integral_decode_plain(maps, rows, centers, strides, shape)
    assert decode_within_gate(got, want, strides, rows)


@pytest.mark.parametrize('k', [1, 33, 4481])
def test_integral_decode_flat_forms_match_plain(cuda, k):
    """The flat (B, N, 68) float32 form (ERD's teacher map: unit strides,
    no clip) with vector loads, and a flat view of a
    69-wide buffer (rows off 16-byte boundaries: scalar loads), at K = 1,
    a ragged 33 and ERD's 4481 (B x K not a multiple of a block's 32)."""
    rs = np.random.RandomState(32 + k)
    ctx = AnchorContext.build(TRAIN_SHAPE)
    centers, _ = ctx.device_tensors(cuda)
    n = ctx.num_anchors
    reg = torch.from_numpy((rs.randn(3, n, 68) * 3).astype(np.float32)).to(
        cuda)
    wide = torch.zeros(3, n, 69, device=cuda)
    wide[..., :68] = reg
    rows = torch.from_numpy(rs.randint(0, n, (3, k))).to(cuda)
    unit = torch.ones(n, device=cuda)
    want = integral_decode_plain(reg, rows, centers, unit, None)
    for logits in (reg, wide[..., :68]):
        got = integral_decode(logits, rows, centers, unit, None)
        torch.cuda.synchronize()
        assert decode_within_gate(got, want, unit, rows)


def test_integral_decode_never_reaches_plain_on_cuda(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises: the plain version is
    never called; other reg_max values and float16 maps raise."""
    import importlib
    integral_module = importlib.import_module('erd_tpu_torch.ops.integral')

    def refuse(*args, **kwargs):
        raise AssertionError('plain decode reached on CUDA')
    monkeypatch.setattr(integral_module, 'integral_decode_plain', refuse)
    rs = np.random.RandomState(33)
    ctx = AnchorContext.build((800, 1344))
    centers, strides = ctx.device_tensors(cuda)
    maps = head_reg_maps(rs, cuda, torch.float32, 'nchw_view', b=1)
    rows = torch.from_numpy(rs.randint(0, ctx.num_anchors, (1, 50))).to(cuda)
    integral_decode(maps, rows, centers, strides, None)
    with pytest.raises(ValueError, match='reg_max'):
        integral_decode([m[..., :60] for m in maps], rows, centers, strides,
                        None, reg_max=14)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        integral_decode([m.half() for m in maps], rows, centers, strides,
                        None)
    with pytest.raises(TypeError, match='int64'):
        integral_decode(maps, rows.int(), centers, strides, None)


def test_gfl_postprocess_decodes_the_head_maps_in_place(cuda, monkeypatch):
    """GFL serving hands the decode the head's distribution maps
    themselves: no cast and no concatenation runs before the launch."""
    from erd_tpu_torch.models.heads import gfl_head
    cfg = Config.fromfile(ERD_CFG)
    cfg.model.depth = 18
    det, net, _ = init_detector(cfg, device=cuda)
    images = torch.from_numpy(np.random.RandomState(34).randint(
        0, 256, (1, 128, 192, 3), np.uint8)).to(cuda)
    meta = stack_to([ImageMeta_make((128, 192))], cuda)
    seen = []

    def spy(*args):
        seen.append(args[0])
        return integral_decode(*args)
    monkeypatch.setattr(gfl_head, 'integral_decode', spy)
    with torch.no_grad():
        cls, reg = det.forward_raw(net, images)
        det.postprocess(det.anchor_context((128, 192)), cls, reg, meta)
    assert len(seen) == 1 and len(seen[0]) == len(reg)
    assert all(a is b for a, b in zip(seen[0], reg))


def ImageMeta_make(hw):
    from erd_tpu_torch.structures import ImageMeta
    return ImageMeta.make(hw, hw, (1.0, 1.0))


def mask_decay_case(rs, b, n, case, hw=(40, 50), num_labels=80):
    """SOLOv2-like decay inputs on the CPU: (B, N) scores, the binarised
    masks' (B, N, N) overlaps and (B, N) areas, int64 labels. Cases: the
    path's (the top half live, the rest 0), random scores on a 1/16 grid
    with zeros, tied top scores, all zero, one class, a negative score and
    sigma < 0 (the kernel computes every term there)."""
    masks = torch.from_numpy(rs.rand(b, n, hw[0] * hw[1]) < 0.3).float()
    masks[:, rs.rand(n) < 0.05] = 0.0
    inter = masks @ masks.transpose(1, 2)
    area = masks.sum(-1)
    scores = torch.from_numpy((rs.randint(0, 16, (b, n)) / 16).astype(
        np.float32))
    labels = torch.from_numpy(rs.randint(0, num_labels, (b, n)))
    if case == 'path':
        scores = torch.sort(torch.rand(b, n, generator=torch.Generator()
                                       .manual_seed(n)), -1,
                            descending=True).values
        scores[:, n // 2:] = 0.0
    elif case == 'tied_top':
        scores[:, :4] = 1.0
    elif case == 'all_zero':
        scores.zero_()
    elif case == 'one_class':
        labels.zero_()
    elif case == 'negative':
        scores[:, 0] = -0.5
    return scores, inter, area, labels


@pytest.mark.parametrize('n', [1, 7, 33, 500, 700])
@pytest.mark.parametrize('case', ['path', 'random', 'tied_top', 'all_zero',
                                  'one_class', 'negative', 'sigma_neg'])
@pytest.mark.parametrize('kernel', ['gaussian', 'linear'])
def test_mask_matrix_decay_kernel_matches_plain(cuda, n, case, kernel):
    """The fused decay (one cooperative launch, the mask IoU made in it,
    zero rows and failing terms skipped; N = 500 takes the row held in
    registers over the barrier, N > 512 is not held) within 1e-6
    relative of plain, zeros equal (and their signs), one counted launch
    a call, on 2 images."""
    from erd_tpu_torch.ops import mask_matrix_decay, mask_matrix_decay_plain
    rs = np.random.RandomState(n)
    scores, inter, area, labels = mask_decay_case(
        rs, 2, n, case, num_labels=1 if case == 'one_class' else 5)
    sigma = -0.5 if case == 'sigma_neg' else 2.0
    before = mask_matrix_decay.launches
    got = mask_matrix_decay(scores.to(cuda), inter.to(cuda), area.to(cuda),
                            labels.to(cuda), sigma, kernel).cpu()
    assert mask_matrix_decay.launches == before + 1
    want = mask_matrix_decay_plain(scores, inter, area, labels, sigma, kernel)
    zero = want == 0
    assert torch.equal(got == 0, zero)
    assert torch.equal(torch.signbit(got[zero]), torch.signbit(want[zero]))
    rel = ((got - want).abs() / want.abs())[~zero]
    assert rel.numel() == 0 or float(rel.max()) <= 1e-6


def test_mask_matrix_decay_never_reaches_plain_on_cuda(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises: neither plain version
    is called; int32 labels and more slots than the kernel's capacity
    raise."""
    import erd_tpu_torch.ops.extra_nms as extra

    def refuse(*args, **kwargs):
        raise AssertionError('plain decay reached on CUDA')
    monkeypatch.setattr(extra, 'mask_matrix_decay_plain', refuse)
    monkeypatch.setattr(extra, 'matrix_decay_plain', refuse)
    rs = np.random.RandomState(35)
    args = [t.to(cuda) for t in mask_decay_case(rs, 1, 20, 'random')]
    extra.mask_matrix_decay(*args)
    with pytest.raises(TypeError, match='int64'):
        extra.mask_matrix_decay(*args[:3], args[3].int())
    monkeypatch.setattr(extra, 'mask_matrix_decay_capacity', lambda: 19)
    with pytest.raises(ValueError, match='at most 19'):
        extra.mask_matrix_decay(*args)
