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
    """K = 12000, above the ~9600 candidates one block holds in shared
    memory: the device-memory variant, 100 steps, linear bit-exact and
    gaussian within 1e-6 relative (the card's expf in both)."""
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


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in bf16 ulps."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(1, 256, 25, 42), (2, 40, 7, 9)])
def test_carafe_kernel_matches_plain(cuda, dtype, shape):
    """The top FPN-CARAFE step of an 800x1344 canvas, and odd sizes with a
    partial channel chunk; peaked logits. float32 within 1e-5 * max|x|
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
@pytest.mark.parametrize('shape', [(2, 256, 25, 42), (2, 40, 7, 9)])
def test_carafe_backward_kernel_matches_plain(cuda, dtype, shape):
    """The top FPN-CARAFE step of an 800x1344 canvas at batch 2, and odd
    sizes with a partial channel chunk; peaked logits. dx and dlogits
    within 1e-5 * max|plain| in float32 (sums over taps and channels in
    another order); in bf16 within one bf16 ulp or 1e-5 * max|plain|."""
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
    assert float((got - want).abs().max()) <= \
        1e-6 * float(maps.float().abs().max())
    # NCHW memory reads the same as channels-last
    assert torch.equal(point_sample(maps.contiguous(), pts), got)


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
    max|plain|; atomics reorder them) and a bf16 P2 (rounded once, within
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
    500, both kernels) within 1e-6 relative of the plain versions; fast NMS
    and nms_match at K = 2000, 80 classes, exactly; two counted launches
    per matrix NMS call (comp, then the decay), one per fast NMS and
    nms_match call."""
    from erd_tpu_torch.ops import (fast_nms, fast_nms_keep, matrix_decay,
                                   matrix_decay_plain, matrix_nms,
                                   matrix_nms_plain, nms_match,
                                   nms_match_leader)
    from erd_tpu_torch.ops.extra_nms import fast_nms_keep_plain
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
    before = fast_nms_keep.launches
    got = fast_nms(boxes.to(cuda), scores.to(cuda), labels.to(cuda), 0.5,
                   valid.to(cuda))
    assert fast_nms_keep.launches == before + 1
    sc = torch.where(valid, scores, torch.full_like(scores, float('-inf')))
    neg, order = torch.sort(-sc, dim=-1, stable=True)
    want = fast_nms_keep_plain(take_rows(boxes, order),
                               torch.gather(labels, 1, order),
                               neg < float('inf'), order, 0.5)
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < want.numel()
    before = nms_match_leader.launches
    keep, leader = nms_match(boxes.to(cuda), scores.to(cuda), 0.5,
                             valid.to(cuda))
    assert nms_match_leader.launches == before + 1
    want_keep, want_leader = nms_match(boxes, scores, 0.5, valid)
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
    matrix_decay call (two launches) a request; the card's decode of its own network
    outputs against the CPU's decode of the same outputs: labels and masks
    equal, scores within 1e-5 relative."""
    from erd_tpu_torch.ops import matrix_decay
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
    before = matrix_decay.launches
    inference_detector(det, net, imgs, scale=(320, 256))
    assert matrix_decay.launches == before + 4
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
