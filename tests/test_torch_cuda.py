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
from erd_tpu_torch.models.heads.gfl_head import AnchorContext
from erd_tpu_torch.ops import (integral_decode, integral_decode_plain,
                               nms_sorted_keep, nms_sorted_keep_plain)
from erd_tpu_torch.structures import stack_to

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
