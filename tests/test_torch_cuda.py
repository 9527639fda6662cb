"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from erd_tpu_torch.apis import inference_detector, init_detector
from erd_tpu_torch.config import Config
from erd_tpu_torch.data import DetPipeline, ImageRecord
from erd_tpu_torch.models.heads.gfl_head import AnchorContext, gfl_targets
from erd_tpu_torch.ops import (integral_decode, integral_decode_plain,
                               map_roi_levels, nms_sorted_keep,
                               nms_sorted_keep_plain, roi_align,
                               roi_align_plain, soft_nms, soft_nms_plain)
from erd_tpu_torch.ops.erd_distill import erd_distill_plain, \
    fused_erd_distill
from erd_tpu_torch.ops.ers_select import ers_select, ers_select_plain, \
    ers_threshold
from erd_tpu_torch.ops.gfl_loss import fused_gfl_loss, gfl_loss_plain
from erd_tpu_torch.structures import GTInstances, stack_to
from erd_tpu_torch.task import atss_assign, atss_assign_plain, valid_flags

pytestmark = pytest.mark.cuda

ERD_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'configs/gfl_increment/gfl_r50_fpn_1x_coco_first_40_incre_last_40_cats.py')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.parametrize('k,thr', [(2000, 0.6), (4481, 0.005), (70, 0.5)])
def test_nms_kernel_matches_plain(cuda, k, thr):
    sboxes, svalid, order = sorted_nms_case(np.random.RandomState(k), 2, k)
    args = [t.to(cuda) for t in (sboxes, svalid, order)]
    before = nms_sorted_keep.launches
    got = nms_sorted_keep(*args, thr)
    torch.cuda.synchronize()
    assert nms_sorted_keep.launches == before + 1
    want = nms_sorted_keep_plain(*args, thr)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), nms_sorted_keep(sboxes, svalid, order,
                                                  thr))


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


def test_atss_kernel_matches_plain(cuda):
    ctx = AnchorContext.build(TRAIN_SHAPE)
    gt = to(train_gt(np.random.RandomState(0), 2), cuda)
    pad = torch.tensor([[800.0, 1344.0], [768.0, 1024.0]], device=cuda)
    vf = valid_flags(ctx.featmap_sizes, ctx.strides, pad)
    args = (ctx.device_anchors(cuda), ctx.num_level_anchors, gt.bboxes,
            gt.labels, gt.mask, vf)
    before = atss_assign.launches
    got = atss_assign(*args)
    torch.cuda.synchronize()
    assert atss_assign.launches == before + 1
    want = atss_assign_plain(*args)
    assert got.pos_mask.sum() > 0
    for name in ('pos_mask', 'gt_idx', 'labels', 'max_overlaps'):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize('levels', [0, 8])
def test_ers_select_kernel_matches_plain(cuda, levels):
    """Lists exactly; a mask entry may differ only where its criterion lies
    within 1e-6 * |thr| of the threshold (sums in another order). bf16
    criteria, or (levels 8) criteria on a grid of 1/8 so that thousands
    tie at the cap boundary."""
    rs = np.random.RandomState(1)
    n = AnchorContext.build(TRAIN_SHAPE).num_anchors
    t_cls = torch.from_numpy((rs.randn(2, n, 40) * 2 - 4).astype(
        np.float32)).to(cuda).bfloat16().float()
    t_reg = torch.from_numpy((rs.randn(2, n, 68) * 2).astype(
        np.float32)).to(cuda).bfloat16().float()
    if levels:
        t_reg = torch.round(t_reg * levels) / levels
    cap = n // 5 + 1
    got = ers_select(t_cls, t_reg, cap)
    torch.cuda.synchronize()
    want = ers_select_plain(t_cls, t_reg, cap)
    assert torch.equal(got[1], want[1])
    crits = (torch.sigmoid(t_cls).amax(-1), t_reg.amax(-1))
    for g, w, crit, near_idx in ((got[0], want[0], crits[0], None),
                                 (got[2], want[2], crits[1], want[1])):
        thr = ers_threshold(crit)[:, None]
        c = crit if near_idx is None else torch.gather(crit, 1, near_idx)
        near = (c - thr).abs() <= 1e-6 * thr.abs()
        assert torch.equal(g & ~near, w & ~near)
    assert 0 < int(got[3].max()) and (got[3] == got[2].sum(-1)).all()


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


def test_gfl_loss_kernel_matches_plain(cuda):
    """Values rtol 1e-4, gradients within 1e-4 relative + 1e-5 * max|g|
    (float32; partial sums in another order)."""
    args = gfl_case(np.random.RandomState(3), cuda)
    outs, grads = [], []
    for fn in (fused_gfl_loss, gfl_loss_plain):
        cls = args[0].clone().requires_grad_(True)
        reg = args[1].clone().requires_grad_(True)
        losses = fn(cls[..., 40:], reg, *args[2:])
        sum(losses).backward()
        outs.append(torch.stack(losses))
        grads.append((cls.grad, reg.grad))
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=0)
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))
    assert grads[0][0][..., :40].abs().max() == 0


def test_erd_distill_kernel_matches_plain(cuda):
    """Per-image values rtol 1e-4, gradients within 1e-4 relative +
    1e-5 * max|g|."""
    rs = np.random.RandomState(4)
    n = AnchorContext.build(TRAIN_SHAPE).num_anchors
    s_cls = torch.from_numpy(rs.randn(2, n, 80).astype(np.float32)).to(cuda)
    s_reg = torch.from_numpy((rs.randn(2, n, 68) * 2).astype(
        np.float32)).to(cuda)
    t_cls = torch.from_numpy((rs.randn(2, n, 40) - 3).astype(
        np.float32)).to(cuda)
    t_reg = torch.from_numpy((rs.randn(2, n, 68) * 2).astype(
        np.float32)).to(cuda)
    cm = torch.from_numpy(rs.rand(2, n) < 0.03).to(cuda)
    kept = torch.from_numpy(rs.rand(2, n) < 0.02).to(cuda)
    outs, grads = [], []
    for fn in (fused_erd_distill, erd_distill_plain):
        sc = s_cls.clone().requires_grad_(True)
        sr = s_reg.clone().requires_grad_(True)
        l_cls, l_reg = fn(sc, sr, t_cls, t_reg, cm, kept)
        (l_cls.sum() + 3 * l_reg.sum()).backward()
        outs.append(torch.stack([l_cls, l_reg]))
        grads.append((sc.grad, sr.grad))
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=0)
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


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
