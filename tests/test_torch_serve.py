"""Port parity of the whole serving slice, and the port's package rules.

The slice: one GFLIncrementERD config (ResNet-18, float32) served through
erd_tpu's and erd_tpu_torch's ``init_detector`` -> ``inference_detector``
with the same weights; detections must agree (masks and labels exactly,
scores within 1e-5, boxes within 1e-2 px).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from erd_tpu.apis.inference import inference_detector as j_inference
from erd_tpu.apis.inference import init_detector as j_init_detector
from erd_tpu.config import Config as JConfig
from erd_tpu_torch.apis import (build_detector, inference_detector,
                                init_detector)
from erd_tpu_torch.config import Config
from erd_tpu_torch.data.transforms import resize_image
from erd_tpu_torch.models import ERDDetector, GFLTestConfig
from erd_tpu_torch.models.weight_import import params_from_jax
from erd_tpu_torch.ops import (cuda_build, integral_decode, nms_select_cfg,
                               nms_sorted_keep, roi_align, soft_nms)
from erd_tpu_torch.ops.erd_distill import fused_erd_distill
from erd_tpu_torch.ops.ers_select import ers_select
from erd_tpu_torch.ops.gfl_loss import fused_gfl_loss
from erd_tpu_torch.task import atss_assign

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERD_CFG = os.path.join(
    ROOT, 'configs/gfl_increment/'
    'gfl_r50_fpn_1x_coco_first_40_incre_last_40_cats.py')


def small_cfg(config_cls):
    cfg = config_cls.fromfile(ERD_CFG)
    cfg.model.depth = 18
    cfg.model.compute_dtype = 'float32'
    return cfg


def test_serving_slice_matches_erd_tpu():
    scale = (192, 128)
    rs = np.random.RandomState(0)
    # already at the target size: no resize, so no resampling noise
    imgs = [rs.randint(0, 256, (128, 192, 3), np.uint8),
            rs.randint(0, 256, (192, 128, 3), np.uint8)]

    jdet, variables, _ = j_init_detector(small_cfg(JConfig), seed=0)
    variables = jax.tree.map(lambda x: np.array(x, np.float32), variables)
    bias = variables['params']['bbox_head']['gfl_cls']['bias']
    variables['params']['bbox_head']['gfl_cls']['bias'] = np.zeros_like(bias)
    want = j_inference(jdet, variables, imgs, scale=scale)

    det, net, _ = init_detector(small_cfg(Config), device='cpu')
    net.load_state_dict(params_from_jax(variables), strict=True)
    got = inference_detector(det, net, imgs, scale=scale)

    for g, w in zip(got, want):
        assert len(w.scores) > 10
        assert len(g.scores) == len(w.scores)
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.bboxes, w.bboxes, rtol=0, atol=1e-2)


def test_port_imports_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import erd_tpu_torch\n'
        'for m in pkgutil.walk_packages(erd_tpu_torch.__path__, '
        '"erd_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "flax", "erd_tpu")]\n'
        'assert not bad, bad\n'
        'print("modules", sum(m.startswith("erd_tpu_torch") for m in '
        'sys.modules))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


def test_kernel_wrappers_never_fall_back():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises."""
    meta = torch.device('meta')
    with pytest.raises(RuntimeError, match='no kernel'):
        nms_sorted_keep(torch.empty(1, 8, 4, device=meta),
                        torch.empty(1, 8, dtype=torch.bool, device=meta),
                        torch.empty(1, 8, dtype=torch.long, device=meta),
                        0.5)
    with pytest.raises(RuntimeError, match='no kernel'):
        integral_decode(torch.empty(1, 10, 68, device=meta),
                        torch.empty(1, 3, dtype=torch.long, device=meta),
                        torch.empty(10, 2, device=meta),
                        torch.empty(10, device=meta),
                        torch.empty(1, 2, device=meta))
    b, n, g = 2, 10, 3
    rows = torch.empty(b, n, device=meta)
    mask = torch.empty(b, n, dtype=torch.bool, device=meta)
    with pytest.raises(RuntimeError, match='no kernel'):
        atss_assign(torch.empty(n, 4, device=meta), [6, 4],
                    torch.empty(b, g, 4, device=meta),
                    torch.empty(b, g, dtype=torch.long, device=meta),
                    torch.empty(b, g, dtype=torch.bool, device=meta), mask)
    with pytest.raises(RuntimeError, match='no kernel'):
        ers_select(torch.empty(b, n, 4, device=meta),
                   torch.empty(b, n, 68, device=meta), 3)
    with pytest.raises(RuntimeError, match='no kernel'):
        fused_gfl_loss(torch.empty(b, n, 4, device=meta),
                       torch.empty(b, n, 68, device=meta),
                       torch.empty(b, n, dtype=torch.long, device=meta),
                       rows, torch.empty(b, n, 4, device=meta), mask,
                       torch.empty((), device=meta),
                       torch.empty(n, 2, device=meta),
                       torch.empty(n, device=meta))
    with pytest.raises(RuntimeError, match='no kernel'):
        fused_erd_distill(torch.empty(b, n, 8, device=meta),
                          torch.empty(b, n, 68, device=meta),
                          torch.empty(b, n, 4, device=meta),
                          torch.empty(b, n, 68, device=meta), mask, mask)
    with pytest.raises(RuntimeError, match='no kernel'):
        roi_align([torch.empty(b, 8, 6, 5, device=meta)],
                  torch.empty(b, n, 4, device=meta),
                  torch.empty(b, n, dtype=torch.int32, device=meta), (4,))
    with pytest.raises(RuntimeError, match='no kernel'):
        soft_nms(torch.empty(b, n, 4, device=meta),
                 torch.empty(b, n, device=meta), 3)


def test_unported_training_and_soft_nms_raise():
    """Both once raised here; the ERD loss and soft-NMS are ported now.
    The ERD config builds the ERD detector, and soft-NMS through
    ``nms_select_cfg`` matches erd_tpu's (selections exactly, linear decay
    scores to 1e-6)."""
    from erd_tpu.ops.nms import soft_nms_select as j_soft_nms_select
    det = build_detector(small_cfg(Config).model)
    assert isinstance(det, ERDDetector) and det.erd.ori_num_classes == 40
    rs = np.random.RandomState(1)
    xy = rs.uniform(0, 200, (80, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(20, 80, (80, 2))],
                           -1).astype(np.float32)
    scores = rs.uniform(0.1, 1.0, 80).astype(np.float32)
    labels = rs.randint(0, 3, 80)
    want = j_soft_nms_select(boxes, scores, labels, 40, iou_threshold=0.6)
    got = nms_select_cfg(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(labels),
                         GFLTestConfig(nms_type='soft_nms', max_per_img=40))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=0)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        cuda_build.nvcc_path()


def test_init_detector_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        init_detector(small_cfg(Config))


def test_resize_matches_cv2_within_one_level():
    cv2 = pytest.importorskip('cv2')
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (97, 131, 3), np.uint8)
    for h, w in [(50, 70), (200, 260), (64, 131)]:
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        got = resize_image(img, (h, w))
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (h, w, diff.max())
