#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (erd_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:
  1. card       the nvidia-smi name and power-limit line;
  2. build      nvcc builds every kernel of erd_tpu_torch/csrc/, in parallel;
  3. kernels    each serving kernel against its plain PyTorch version on the
                card at serving shapes (NMS keep masks exactly equal; the
                decode within 1e-4 * stride + 1e-5 * |box| px), then timed;
  4. reference  the full-width float32 network on the card against the same
                network on the CPU, on a small input;
  5. serve      4 requests through init_detector / inference_detector of the
                ERD stage-2 GFL-R50 detector (80 classes, bf16, seeded
                random weights, gfl_cls bias 0) on both canvases; every
                kernel of the path must have launched; the same head outputs
                post-processed on the CPU must give the same detections;
  6. train kernels  the training kernels against their plain versions at
                B = 2 and at the train step's B = 16, N = 22400 (ATSS and
                the ERS lists exactly, ERS masks exactly away from the
                threshold, the fused losses within stated tolerances,
                forward and backward; the decode without clip and the NMS on
                the ERS teacher rows at K = 1024 and 4481), then timed at
                B = 16;
  7. train reference  the full-width float32 ERD loss dict and student
                gradients on the card (kernels) and on the CPU (plain
                versions), on a small input; then two controls, a 1 % error
                planted in the GFL or the distillation kernel's backward,
                each of which must fail the same limits;
  8. train      build_trainer + fit of the ERD stage-2 GFL-R50 step (bf16,
                fp32 master weights) at batch 16, 800x1344: 2 warm-up and 5
                timed steps; every kernel of the path must have launched,
                losses finite, frozen stages and the teacher unchanged;
                stage times and the device idle share of one step;
  9. frcnn kernels  one 800x1333 request of Faster R-CNN R50-FPN (80
                classes, bf16) with its kernel calls captured: RoIAlign on
                the 1000 real proposals plus edge-case boxes, full-width
                P2-P5 (within 1e-6 * max|feat|, levels equal on card and
                CPU); soft-NMS at K = 2000, 100 steps (linear bit-exact,
                gaussian within 1e-6 relative); the NMS on the RPN call
                (K = 4819, IoU 0.7) and the R-CNN call (K = 2000, IoU 0.5),
                masks exactly; then each timed;
 10. frcnn serve  for the hard-NMS and the soft-NMS config: init_detector /
                inference_detector on the same 4 requests (seeded fc_cls
                weights so that at least 2000 candidates reach the final
                NMS), every kernel of the path launched, stage times, the
                idle share of one request; the float32 network card vs CPU
                and the same head outputs post-processed on card and CPU;
 11. the {"kernels": [...]} line, then the {"ok": true, ...} line.

TF32 is off for both cuDNN and matmuls: the served and trained models
compute in bf16, and the float32 references compare full-precision float32
on both devices. The script imports neither JAX nor erd_tpu.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
ERD_CONFIG = os.path.join(
    ROOT, 'configs', 'gfl_increment',
    'gfl_r50_fpn_1x_coco_first_40_incre_last_40_cats.py')
FRCNN_CONFIGS = {
    'nms': os.path.join(ROOT, 'configs', 'faster_rcnn',
                        'faster_rcnn_r50_fpn_1x_coco.py'),
    'soft_nms': os.path.join(ROOT, 'configs', 'faster_rcnn',
                             'faster_rcnn_r50_fpn_soft_nms_1x_coco.py')}
# seeded fc_cls of the Faster R-CNN serve cell (see arrange_fc_cls): about
# five classes of each RoI pass score_thr, so that the NMS sees 2000
FC_CLS_SEED, FC_CLS_STD, FC_CLS_BOOSTED, FC_CLS_BOOST = 7, 0.5, 8, 2.5
ROI_STRIDES = (4, 8, 16, 32)
# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# the four requests: (H, W) of seeded random RGB images
REQUESTS = [(480, 640), (640, 480), (427, 640), (800, 1333)]
NUM_CLASSES = 80
OLD_CLASSES = 40
# the training step: batch, canvas, warm-up and timed steps
TRAIN_BATCH = 16
TRAIN_CANVAS = (800, 1344)
TRAIN_IMAGE = (800, 1333)  # (H, W) of each image inside the canvas
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
MAX_GT = 16
# the card the new phases run on (a rehearsal on the CPU sets 'cpu')
DEV = 'cuda'


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(out, 'nvidia-smi printed no card')
    return out[0].strip()


def events_ms(torch, fn, n):
    """Per-call ms on the card's timeline (CUDA events around n calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(torch, fn, names, n):
    """Per-call device time of the named kernels (torch.profiler), or None
    when the profiler reports no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if any(name in ev.key for name in names):
            total_us += getattr(ev, 'device_time_total', None) or \
                getattr(ev, 'cuda_time_total', 0.0)
    return total_us / n / 1e3 if total_us > 0 else None


def profile_request(torch, fn, tag='profile'):
    """Device busy share and the top kernels of one warm request."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(ev, 'self_cuda_time_total', 0.0)
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    log(f'{tag}: one 800x1333 request, wall {wall_ms:.2f} ms (profiled), '
        f'device kernels {busy:.2f} ms, device idle share '
        f'{max(0.0, 1 - busy / wall_ms):.3f}')
    for dev, count, key in sorted(rows, reverse=True)[:10]:
        log(f'{tag}:   {dev:8.3f} ms  x{count:<4d} {key[:90]}')


def nms_case(np, torch, rs, b, k, num_labels=NUM_CLASSES):
    """Clustered overlapping boxes over many labels, 10% invalid entries,
    tied scores; sorted and class-shifted as ``nms_mask`` hands them to the
    kernel."""
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
    return [torch.from_numpy(np.stack(a)).cuda()
            for a in (boxes, valid, order)]


def phase_kernels(np, torch):
    from erd_tpu_torch.models.heads.gfl_head import AnchorContext
    from erd_tpu_torch.ops import (integral_decode, integral_decode_plain,
                                   nms_sorted_keep, nms_sorted_keep_plain)
    rs = np.random.RandomState(0)
    rows_out = []

    # -- A: NMS, exact keep masks at predict (K=2000, IoU 0.6) and at the
    # training slice's distillation size (K=4481, IoU 0.005)
    for b, k, thr in [(2, 2000, 0.6), (2, 4481, 0.005)]:
        args = nms_case(np, torch, rs, b, k)
        got = nms_sorted_keep(*args, thr)
        torch.cuda.synchronize()
        want = nms_sorted_keep_plain(*args, thr)
        diff = int((got != want).sum())
        log(f'kernels: nms B={b} K={k} iou={thr} kept={int(got.sum())} '
            f'mismatches={diff}')
        check(diff == 0, f'NMS kernel disagrees with plain at K={k}')
        check(0 < int(got.sum()) < int(args[1].sum()),
              'NMS check suppressed nothing or everything')
    # timing at the serving path's shapes: one image, K = 2000
    args = nms_case(np, torch, rs, 1, 2000)
    nms_call_ms = events_ms(torch, lambda: nms_sorted_keep(*args, 0.6), 20)
    nms_ms = kernel_ms(torch, lambda: nms_sorted_keep(*args, 0.6),
                       ['nms_mask_kernel', 'nms_reduce_kernel'], 20)
    nms_plain_ms = events_ms(
        torch, lambda: nms_sorted_keep_plain(*args, 0.6), 5)
    sboxes, svalid = args[0], args[1]
    k = sboxes.shape[1]
    valid_idx = torch.nonzero(svalid[0]).flatten().double()
    pairs = float((k - 1 - valid_idx).sum())
    nms_ops = 14.0 * pairs + 3.0 * k  # per pair: min/max x4, sub x3, max0
    # x2, mul, add, max, div, compare; per box: its area
    nms_bytes = k * (16 + 1 + 8) + k * 1
    rows_out.append(dict(
        name='nms_keep', route='cuda',
        source='erd_tpu_torch/csrc/nms.cu',
        replaces='erd_tpu/ops/nms.py:50',
        max_abs_err=0.0, ms=nms_ms or nms_call_ms, call_ms=nms_call_ms,
        ms_from='profiler' if nms_ms else 'events',
        plain_ms=nms_plain_ms,
        bound_ms=1e3 * max(nms_bytes / PEAK_BYTES_PER_S,
                           nms_ops / PEAK_FP32_PER_S),
        bound_by='operations' if nms_ops / PEAK_FP32_PER_S >
        nms_bytes / PEAK_BYTES_PER_S else 'bytes',
        library_ms=None))

    # -- B: decode, (2, 22400, 68) logits, 1000 candidate rows per level
    ctx = AnchorContext.build((800, 1344))
    centers, strides = ctx.device_tensors('cuda')
    n = ctx.num_anchors
    starts = np.concatenate([[0], np.cumsum(ctx.num_level_anchors)])

    def candidate_rows(b):
        return torch.from_numpy(np.stack([np.concatenate([
            rs.randint(starts[i], starts[i + 1], 1000) for i in range(5)])
            for _ in range(b)])).cuda()

    reg = torch.from_numpy(
        (rs.randn(2, n, 68) * 3).astype(np.float32)).cuda()
    rows = candidate_rows(2)
    img_shape = torch.tensor([[800.0, 1333.0], [800.0, 1200.0]]).cuda()
    got = integral_decode(reg, rows, centers, strides, img_shape)
    torch.cuda.synchronize()
    want = integral_decode_plain(reg, rows, centers, strides, img_shape)
    err = (got - want).abs()
    tol = 1e-4 * strides[rows].unsqueeze(-1) + 1e-5 * want.abs()
    dec_err = float(err.max())
    log(f'kernels: integral_decode B=2 N={n} K={rows.shape[1]} '
        f'max_abs_err={dec_err:.3e} px (tolerance 1e-4*stride+1e-5*|box|)')
    check(bool((err <= tol).all()), 'decode kernel disagrees with plain')
    reg1, rows1, shape1 = reg[:1].contiguous(), rows[:1].contiguous(), \
        img_shape[:1].contiguous()
    dec = (lambda: integral_decode(reg1, rows1, centers, strides, shape1))
    dec_call_ms = events_ms(torch, dec, 50)
    dec_ms = kernel_ms(torch, dec, ['integral_decode_kernel'], 50)
    dec_plain_ms = events_ms(torch, lambda: integral_decode_plain(
        reg1, rows1, centers, strides, shape1), 50)
    kc = rows1.shape[1]
    uniq = int(torch.unique(rows1).numel())
    dec_bytes = uniq * (68 * 4 + 8 + 4) + kc * 8 + 8 + kc * 16
    dec_ops = kc * 4 * 121.0  # per side: 16 max, 17 sub, 17 exp, 16 add,
    # 17 div, 17 mul, 17 add, stride mul, centre add, 2 clips
    rows_out.append(dict(
        name='integral_decode', route='cuda',
        source='erd_tpu_torch/csrc/integral_decode.cu',
        replaces='erd_tpu/ops/integral.py:14',
        max_abs_err=dec_err, ms=dec_ms or dec_call_ms, call_ms=dec_call_ms,
        ms_from='profiler' if dec_ms else 'events',
        plain_ms=dec_plain_ms,
        bound_ms=1e3 * max(dec_bytes / PEAK_BYTES_PER_S,
                           dec_ops / PEAK_FP32_PER_S),
        bound_by='bytes' if dec_bytes / PEAK_BYTES_PER_S >=
        dec_ops / PEAK_FP32_PER_S else 'operations',
        library_ms=None))
    log('kernels: library_ms is null for both: no single PyTorch call '
        'computes greedy NMS (no torchvision) or the fused decode')
    return rows_out


def phase_reference(np, torch):
    """Full-width float32 network, card vs CPU, on one small input."""
    import copy

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    cfg = Config.fromfile(ERD_CONFIG)
    cfg.model.compute_dtype = 'float32'
    det = build_detector(cfg.model)
    net_cpu = det.init(seed=1, device='cpu')
    net_gpu = copy.deepcopy(net_cpu).cuda()
    img = np.random.RandomState(2).randint(0, 256, (1, 128, 192, 3),
                                           np.uint8)
    want = det.forward_raw(net_cpu, torch.from_numpy(img))
    got = det.forward_raw(net_gpu, torch.from_numpy(img).cuda())
    worst = 0.0
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        check(tuple(g.shape) == tuple(w.shape), 'reference shape mismatch')
        rel = float((g.cpu() - w).abs().max() / w.abs().max())
        worst = max(worst, rel)
    log(f'reference: float32 network card vs CPU, max |diff| / max |out| '
        f'= {worst:.2e} (tolerance 1e-3)')
    check(worst <= 1e-3, 'float32 network on the card disagrees with CPU')


def phase_serve(np, torch, card):
    from erd_tpu_torch.apis import inference_detector, init_detector
    from erd_tpu_torch.data import DetPipeline, ImageRecord
    from erd_tpu_torch.ops import integral_decode, nms_sorted_keep
    from erd_tpu_torch.structures import stack_to

    det, net, cfg = init_detector(ERD_CONFIG, device='cuda')
    check(type(det).__name__ == 'ERDDetector', 'not the ERD detector')
    check(det.num_classes == NUM_CLASSES and det.depth == 50 and
          det.compute_dtype == torch.bfloat16, 'not the GFL-R50 bf16 model')
    with torch.no_grad():
        net.bbox_head.gfl_cls.bias.zero_()  # scores near 0.5: full NMS
    rs = np.random.RandomState(3)
    images = [rs.randint(0, 256, (h, w, 3), np.uint8) for h, w in REQUESTS]

    inference_detector(det, net, images)  # warm-up (cuDNN, kernel loads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_sorted_keep.launches = 0
    integral_decode.launches = 0
    results, latency = [], []
    for img in images:
        t0 = time.perf_counter()
        results.append(inference_detector(det, net, img))
        torch.cuda.synchronize()
        latency.append(time.perf_counter() - t0)
    launches = {'nms_keep': nms_sorted_keep.launches,
                'integral_decode': integral_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f'serve: launches on the main path {launches}')
    for name, count in launches.items():
        check(count > 0, f'kernel {name} was not launched by the main path')

    pipe = DetPipeline()
    for i, (img, res) in enumerate(zip(images, results)):
        h, w = img.shape[:2]
        n = len(res.scores)
        check(0 < n <= 100, f'request {i}: {n} detections')
        check(np.isfinite(res.bboxes).all() and np.isfinite(
            res.scores).all(), f'request {i}: non-finite output')
        slack = 1e-3 * max(h, w)
        check((res.bboxes >= -slack).all() and
              (res.bboxes[:, [0, 2]] <= w + slack).all() and
              (res.bboxes[:, [1, 3]] <= h + slack).all(),
              f'request {i}: boxes outside the image')
        check(((res.labels >= 0) & (res.labels < NUM_CLASSES)).all(),
              f'request {i}: labels out of range')
        # the same head outputs through the card's and the CPU's
        # post-processing (kernels vs plain versions)
        rec = ImageRecord(i, '', w, h, np.zeros((0, 4), np.float32),
                          np.zeros((0,), np.int32), np.zeros((0,), bool))
        # stage times of the same request, each ended by a synchronize
        t0 = time.perf_counter()
        canvas, _, meta = pipe(rec, image=img)
        batch_images = torch.from_numpy(canvas[None]).cuda()
        meta_gpu = stack_to([meta], 'cuda')
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ctx = det.anchor_context(batch_images.shape[1:3])
        cls, reg = det.forward_raw(net, batch_images)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gpu = det.postprocess(ctx, cls, reg, meta_gpu)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        log(f'serve: request {i} stages ms: host pipeline + upload '
            f'{1e3 * (t1 - t0):.2f}, network {1e3 * (t2 - t1):.2f}, '
            f'post-processing {1e3 * (t3 - t2):.2f}')
        cpu = det.postprocess(ctx, [c.cpu() for c in cls],
                              [r.cpu() for r in reg],
                              stack_to([meta], 'cpu'))
        cand = int(gpu.num_candidates[0])
        box_err = float((gpu.bboxes.cpu() - cpu.bboxes).abs().max())
        score_err = float((gpu.scores.cpu() - cpu.scores).abs().max())
        log(f'serve: request {i} image {h}x{w} canvas {canvas.shape[0]}x'
            f'{canvas.shape[1]} candidates_into_nms={cand} detections={n} '
            f'card_vs_cpu max_box_err={box_err:.2e}px '
            f'max_score_err={score_err:.2e}')
        check(cand > 0, f'request {i}: no candidates entered NMS')
        check(cand == int(cpu.num_candidates[0]),
              f'request {i}: candidate count differs on the CPU')
        check(torch.equal(gpu.mask.cpu(), cpu.mask) and
              torch.equal(gpu.labels.cpu(), cpu.labels),
              f'request {i}: card and CPU detections differ')
        check(box_err <= 1e-2 and score_err <= 1e-6,
              f'request {i}: card and CPU boxes/scores differ')
        check(int(gpu.mask.sum()) == n,
              f'request {i}: predict and inference_detector disagree')

    profile_request(torch, lambda: inference_detector(det, net, images[-1]))
    total = sum(latency)
    log('serve: warm per-request latency ms ' +
        ' '.join(f'{1e3 * t:.2f}' for t in latency) +
        f'; {len(latency) / total:.2f} img/s; peak memory '
        f'{peak / 2**20:.1f} MiB; card {card}')
    return launches


def bound_of(nbytes, ops):
    """(bound ms, 'bytes' or 'operations') at the H100 peaks above."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(tb, to), 'bytes' if tb >= to else 'operations'


def time_pair(torch, fn, plain_fn, names, n=10):
    """(kernel ms, call ms, source, plain ms): device time of the named
    kernels per call (profiler, or events when it shows none), the call's
    event time, and the plain version's event time."""
    call_ms = events_ms(torch, fn, n)
    dev_ms = kernel_ms(torch, fn, names, n)
    plain_ms = events_ms(torch, plain_fn, max(2, n // 3))
    return (dev_ms or call_ms, call_ms,
            'profiler' if dev_ms else 'events', plain_ms)


def synthetic_gt(np, torch, rs, b, img_hw, device=None):
    """1-12 random gt boxes per image in MAX_GT padded slots, inside the
    (H, W) image, labels of the 40 new classes (0..39)."""
    h, w = img_hw
    boxes = np.zeros((b, MAX_GT, 4), np.float32)
    labels = np.zeros((b, MAX_GT), np.int64)
    mask = np.zeros((b, MAX_GT), bool)
    for i in range(b):
        g = rs.randint(1, 13)
        wh = rs.uniform(16, min(h, w) / 2, (g, 2))
        x1 = rs.uniform(0, w - wh[:, 0])
        y1 = rs.uniform(0, h - wh[:, 1])
        boxes[i, :g] = np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], -1)
        labels[i, :g] = rs.randint(0, NUM_CLASSES - OLD_CLASSES, g)
        mask[i, :g] = True
    from erd_tpu_torch.structures import GTInstances
    device = device or DEV
    return GTInstances(bboxes=torch.from_numpy(boxes).to(device),
                       labels=torch.from_numpy(labels).to(device),
                       mask=torch.from_numpy(mask).to(device))


def train_case(np, torch, rs, ctx, b):
    """Head outputs and targets of one batch, as the train step hands them
    to the kernels: teacher logits are bf16 values in float32, with a few
    confident rows per image."""
    from erd_tpu_torch.models.heads.gfl_head import gfl_targets
    n = ctx.num_anchors

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rs.randn(*shape) * scale + shift).astype(
            np.float32)).to(DEV)
    t_cls = randn(b, n, OLD_CLASSES, scale=1.5, shift=-4.0)
    t_reg = randn(b, n, 68, scale=2.0)
    hot = torch.from_numpy(rs.rand(b, n) < 0.01).to(DEV)
    t_cls = torch.where(hot[..., None], t_cls + 6.0, t_cls).bfloat16().float()
    t_reg = torch.where(hot[..., None], t_reg + 3.0, t_reg).bfloat16().float()
    gt = synthetic_gt(np, torch, rs, b, TRAIN_IMAGE)
    img_shape = torch.tensor([list(map(float, TRAIN_IMAGE))] * b, device=DEV)
    targets = gfl_targets(ctx, gt, img_shape, NUM_CLASSES - OLD_CLASSES)
    return dict(gt=gt, img_shape=img_shape, targets=targets, t_cls=t_cls,
                t_reg=t_reg, s_cls=randn(b, n, NUM_CLASSES, scale=2.0,
                                         shift=-3.0),
                s_reg=randn(b, n, 68, scale=2.0))


def phase_train_kernels(np, torch):
    """The training kernels against their plain versions at B = 2 and at
    the train step's B = 16, then timed at B = 16."""
    import erd_tpu_torch.ops.nms as nms_module
    from erd_tpu_torch.models.detectors.gfl_erd import _kept_dense
    from erd_tpu_torch.models.heads.gfl_head import AnchorContext
    from erd_tpu_torch.ops import (integral_decode, integral_decode_plain,
                                   nms_sorted_keep, nms_sorted_keep_plain)
    from erd_tpu_torch.ops.erd_distill import (erd_distill_plain,
                                               fused_erd_distill)
    from erd_tpu_torch.ops.ers_select import (ers_select, ers_select_plain,
                                              ers_threshold)
    from erd_tpu_torch.ops.gfl_loss import fused_gfl_loss, gfl_loss_plain
    from erd_tpu_torch.task import atss_assign, atss_assign_plain, valid_flags

    rs = np.random.RandomState(5)
    ctx = AnchorContext.build(TRAIN_CANVAS)
    n = ctx.num_anchors
    cap = n // 5 + 1
    fast_k = 1024  # the config's ERDConfig.ers_nms_fast_k
    anchors = ctx.device_anchors(DEV)
    centers, strides = ctx.device_tensors(DEV)
    unit = torch.ones(n, device=DEV)
    nla = ctx.num_level_anchors
    rows = []

    def atss_args(case):
        pad = torch.ceil(case['img_shape'] / 32) * 32
        vf = valid_flags(ctx.featmap_sizes, ctx.strides, pad)
        gt = case['gt']
        return (anchors, nla, gt.bboxes, gt.labels, gt.mask, vf)

    def gfl_args(case):
        t = case['targets']
        return (t.labels, t.label_weights, t.bbox_targets, t.pos_mask,
                t.num_pos, centers, strides)

    def gfl_step(fn, case, cls, reg):
        losses = fn(cls[..., OLD_CLASSES:], reg, *gfl_args(case))
        sum(losses).backward()
        return losses

    def ers_nms(case, k):
        """The ERS masks, the first k reg candidates, the rows the NMS kept
        as erd_distill_losses makes them, and the arguments the NMS kernel
        was handed there (the teacher's decoded rows, sorted and shifted
        by class)."""
        cm, ri, rm, count = ers_select(case['t_cls'], case['t_reg'], cap)
        ri, rm = ri[:, :k].contiguous(), rm[:, :k].contiguous()
        seen = []
        restore = capture(nms_module, 'nms_sorted_keep', seen)
        try:
            kept = _kept_dense(centers, unit, case['t_cls'], case['t_reg'],
                               ri, rm, 0.005, 16)
        finally:
            restore()
        check(len(seen) == 1, 'the distillation NMS ran other than once')
        return cm, ri, kept, count, seen[0]

    def distill_step(fn, case, s_cls, s_reg, cm, kept):
        l_cls, l_reg = fn(s_cls, s_reg, case['t_cls'], case['t_reg'], cm,
                          kept)
        (l_cls.sum() + l_reg.sum()).backward()
        return l_cls, l_reg

    def with_grad(case):
        return (case['s_cls'].clone().requires_grad_(True),
                case['s_reg'].clone().requires_grad_(True))

    def grad_ratio(grads):
        """Largest |kernel - plain| / (1e-4*|plain| + 1e-5*max|plain|)."""
        return max(float(((g - w).abs() / (1e-4 * w.abs() + 1e-5 * float(
            w.abs().max()))).max()) for g, w in zip(*grads))

    def check_case(case):
        """Every training kernel against its plain version on one batch;
        returns the largest errors of the decode and the fused losses."""
        b = case['t_cls'].shape[0]
        got = atss_assign(*atss_args(case))
        want = atss_assign_plain(*atss_args(case))
        diff = sum(int((getattr(got, f) != getattr(want, f)).sum())
                   for f in ('pos_mask', 'gt_idx', 'labels', 'max_overlaps'))
        log(f'train kernels: atss B={b} N={n} G={MAX_GT} positives='
            f'{int(got.pos_mask.sum())} mismatches={diff} (exact)')
        check(diff == 0, f'ATSS kernel disagrees with plain at B={b}')
        check(int(got.pos_mask.sum()) > 0, 'ATSS check found no positive')

        got = ers_select(case['t_cls'], case['t_reg'], cap)
        want = ers_select_plain(case['t_cls'], case['t_reg'], cap)
        check(torch.equal(got[1], want[1]),
              f'ERS reg list differs from plain at B={b}')
        flips = 0
        crit_cls = torch.sigmoid(case['t_cls']).amax(-1)
        crit_reg = case['t_reg'].amax(-1)
        for g, w, crit, full in (
                (got[0], want[0], crit_cls, crit_cls),
                (got[2], want[2], torch.gather(crit_reg, 1, want[1]),
                 crit_reg)):
            thr = ers_threshold(full)[:, None]
            near = (crit - thr).abs() <= 1e-6 * thr.abs()
            check(torch.equal(g & ~near, w & ~near),
                  f'ERS mask differs from plain away from the threshold at '
                  f'B={b}')
            flips += int((g != w).sum())
        log(f'train kernels: ers_select B={b} N={n} cap={cap} cls rows '
            f'{int(got[0].sum())}, largest reg count {int(got[3].max())}; '
            f'lists exact, mask flips within 1e-6*|thr| of the threshold: '
            f'{flips}')
        check(bool((got[3] > 0).all()), 'ERS check selected nothing')

        dec_err = 0.0
        for k in (fast_k, cap):
            _, ri, kept, _, nargs = ers_nms(case, k)
            dec = integral_decode(case['t_reg'], ri, centers, unit, None)
            dec_want = integral_decode_plain(case['t_reg'], ri, centers,
                                             unit, None)
            err = (dec - dec_want).abs()
            dec_err = max(dec_err, float(err.max()))
            check(bool((err <= 1e-4 + 1e-5 * dec_want.abs()).all()),
                  f'no-clip decode disagrees with plain at B={b} K={k}')
            check(k == fast_k or bool((dec_want < 0).any()),
                  'no-clip decode check clipped nothing')
            mism = int((nms_sorted_keep(*nargs) !=
                        nms_sorted_keep_plain(*nargs)).sum())
            log(f'train kernels: ERS teacher rows B={b} K={k}: no-clip '
                f'unit-stride decode max_abs_err={float(err.max()):.3e} '
                f'(tolerance 1e-4 + 1e-5*|box|); NMS iou=0.005 kept '
                f'{int(kept.sum())}, mismatches={mism} (exact)')
            check(mism == 0, f'NMS kernel disagrees with plain at B={b} '
                  f'K={k}')

        outs, grads = [], []
        for fn in (fused_gfl_loss, gfl_loss_plain):
            cls, reg = with_grad(case)
            outs.append(torch.stack(gfl_step(fn, case, cls, reg)).detach())
            grads.append((cls.grad, reg.grad))
        del cls, reg
        gfl_err = float((outs[0] - outs[1]).abs().max())
        gfl_gerr = grad_ratio(grads)
        log(f'train kernels: gfl_loss B={b} losses {outs[0].tolist()} vs '
            f'plain {outs[1].tolist()}; max_abs_err={gfl_err:.3e} '
            f'(tolerance rtol 1e-4); gradient error / tolerance '
            f'(1e-4*|g|+1e-5*max|g|) = {gfl_gerr:.3f}')
        check(bool(((outs[0] - outs[1]).abs() <=
                    1e-4 * outs[1].abs()).all()),
              f'GFL loss kernel disagrees with plain at B={b}')
        check(gfl_gerr <= 1.0, f'GFL loss backward disagrees with plain at '
              f'B={b}')

        # the masks of the fast branch, which the path takes while every
        # image's reg count fits in fast_k (it does on this data)
        cm, _, kept, _, _ = ers_nms(case, fast_k)
        outs, grads = [], []
        for fn in (fused_erd_distill, erd_distill_plain):
            sc, sr = with_grad(case)
            outs.append(torch.stack(distill_step(fn, case, sc, sr, cm,
                                                 kept)).detach())
            grads.append((sc.grad, sr.grad))
        del sc, sr
        dis_err = float((outs[0] - outs[1]).abs().max())
        dis_gerr = grad_ratio(grads)
        log(f'train kernels: erd_distill B={b} rows cls {int(cm.sum())} '
            f'kept {int(kept.sum())}; summed losses '
            f'{outs[0].sum(-1).tolist()}; max_abs_err={dis_err:.3e} '
            f'(tolerance rtol 1e-4); gradient error / tolerance = '
            f'{dis_gerr:.3f}')
        check(bool(((outs[0] - outs[1]).abs() <=
                    1e-4 * outs[1].abs()).all()),
              f'distillation kernel disagrees with plain at B={b}')
        check(dis_gerr <= 1.0, f'distillation backward disagrees with plain '
              f'at B={b}')
        check(bool((outs[0] > 0).all()), 'distillation check is zero')
        return dict(decode=dec_err, gfl=gfl_err, distill=dis_err)

    # ---- checks at B = 2 and at the train step's B = 16
    errs = {}
    for b in (2, TRAIN_BATCH):
        case = train_case(np, torch, rs, ctx, b)
        for key, err in check_case(case).items():
            errs[key] = max(errs.get(key, 0.0), err)
    big = case

    # ---- timing at B = 16
    b = TRAIN_BATCH
    a_args = atss_args(big)
    ms, call_ms, src, plain_ms = time_pair(
        torch, lambda: atss_assign(*a_args),
        lambda: atss_assign_plain(*a_args),
        ['atss_candidates_kernel', 'atss_resolve_kernel'])
    n_gt = int(big['gt'].mask.sum())
    nbytes = n * 16 + b * MAX_GT * 25 + b * n * (1 + 1 + 8 + 4 + 8)
    ops = n_gt * n * 7.0  # per (gt, anchor): centre distance (2 sub, 2 mul,
    # add, sqrt) and the compare of the per-level selection
    bms, by = bound_of(nbytes, ops)
    rows.append(dict(name='atss', route='cuda',
                     source='erd_tpu_torch/csrc/atss.cu',
                     replaces='erd_tpu/task/atss.py:46', max_abs_err=0.0,
                     ms=ms, call_ms=call_ms, ms_from=src, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=None))

    ms, call_ms, src, plain_ms = time_pair(
        torch, lambda: ers_select(big['t_cls'], big['t_reg'], cap),
        lambda: ers_select_plain(big['t_cls'], big['t_reg'], cap),
        ['ers_criteria_kernel', 'ers_stats_kernel', 'ers_rank_kernel'])
    nbytes = b * n * (OLD_CLASSES + 68) * 4 + b * n + b * cap * 9 + b * 4
    ops = b * n * (OLD_CLASSES * 4.0 + 68 + 6)  # sigmoids, maxima, moments
    bms, by = bound_of(nbytes, ops)
    rows.append(dict(name='ers_select', route='cuda',
                     source='erd_tpu_torch/csrc/ers_select.cu',
                     replaces='erd_tpu/models/detectors/gfl_erd.py:96',
                     max_abs_err=0.0, ms=ms, call_ms=call_ms, ms_from=src,
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None))

    cls, reg = with_grad(big)
    ms, call_ms, src, plain_ms = time_pair(
        torch, lambda: gfl_step(fused_gfl_loss, big, cls, reg),
        lambda: gfl_step(gfl_loss_plain, big, cls, reg),
        ['_gfl_loss_kernel', '_gfl_reduce_kernel'])
    m = b * n
    # forward reads 40 class + 68 distribution logits, targets and masks of
    # every row; backward reads them again and writes both gradients
    nbytes = m * (2 * (40 * 4 + 68 * 4 + 8 + 4 + 16 + 1) + 40 * 4 + 68 * 4) \
        + n * 12
    ops = m * 3300.0  # forward ~1300, backward ~2000 per row (softmaxes,
    # sigmoids, logs, GIoU and its gradient)
    bms, by = bound_of(nbytes, ops)
    rows.append(dict(name='gfl_loss', route='triton',
                     source='erd_tpu_torch/ops/gfl_loss.py',
                     replaces='erd_tpu/models/heads/gfl_head.py:211',
                     max_abs_err=errs['gfl'], ms=ms, call_ms=call_ms,
                     ms_from=src, ms_per='forward + backward',
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None))
    del cls, reg

    cm, _, kept, count, _ = ers_nms(big, fast_k)
    sc, sr = with_grad(big)
    ms, call_ms, src, plain_ms = time_pair(
        torch, lambda: distill_step(fused_erd_distill, big, sc, sr, cm,
                                    kept),
        lambda: distill_step(erd_distill_plain, big, sc, sr, cm, kept),
        ['_distill_kernel', '_distill_reduce_kernel'])
    n_cm, n_kp = int(cm.sum()), int(kept.sum())
    n_s = int((cm | kept).sum())
    reads = m * 2 + n_s * 160 + n_cm * 160 + n_kp * 68 * 4 * 2
    nbytes = 2 * reads + m * (40 + 68) * 4 + b * 8
    ops = 2 * (n_kp * 4 * 17 * 16.0 + n_cm * 40 * 3.0 + n_s * 40 * 4.0)
    bms, by = bound_of(nbytes, ops)
    rows.append(dict(name='erd_distill', route='triton',
                     source='erd_tpu_torch/ops/erd_distill.py',
                     replaces='erd_tpu/models/detectors/gfl_erd.py:178',
                     max_abs_err=errs['distill'], ms=ms, call_ms=call_ms,
                     ms_from=src, ms_per='forward + backward',
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None))
    log(f'train kernels: B={b} ERS rows cls {n_cm}, kept {n_kp}, largest '
        f'reg count {int(count.max())}')
    del sc, sr

    # the decode and NMS on the ERS teacher rows at both branches' sizes
    # (their rows of the JSON line come from the serving phase; these are
    # the same kernels on the train path)
    extra = {}
    for k in (fast_k, cap):
        _, ri, _, _, nargs = ers_nms(big, k)
        dec_ms = events_ms(torch, lambda: integral_decode(
            big['t_reg'], ri, centers, unit, None), 20)
        nms_ms = events_ms(torch, lambda: nms_sorted_keep(*nargs), 5)
        extra[k] = (dec_ms, nms_ms)
        log(f'train kernels: B={b} K={k}: decode {dec_ms:.4f} ms, NMS '
            f'{nms_ms:.4f} ms per call (events)')
    del big, case
    torch.cuda.empty_cache()
    log('train kernels: library_ms is null for all four: no single PyTorch '
        'call computes ATSS, the ERS selection, the fused GFL loss or the '
        'fused distillation')
    return rows, extra, errs['decode']


def phase_train_reference(np, torch):
    """Full-width float32 ERD loss and student gradients, card (kernels)
    vs CPU (plain versions), on a small input; then two controls, each with
    a 1 % error planted in one kernel's backward, which must fail."""
    import copy

    import erd_tpu_torch.models.detectors.gfl_erd as gfl_erd_module
    import erd_tpu_torch.models.heads.gfl_head as gfl_head_module
    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.structures import ImageMeta, stack_to
    cfg = Config.fromfile(ERD_CONFIG)
    cfg.model.compute_dtype = 'float32'
    det = build_detector(cfg.model)
    teacher = det.init_teacher(seed=11, device='cpu')
    student = det.init_student_from_teacher(12, teacher, device='cpu')
    gen = torch.Generator().manual_seed(14)
    with torch.no_grad():  # diverge the student's head from the teacher
        for conv in (student.bbox_head.gfl_cls, student.bbox_head.gfl_reg):
            conv.weight.add_(0.01 * torch.randn(conv.weight.shape,
                                                generator=gen))
    rs = np.random.RandomState(13)
    h, w = 128, 192
    images = torch.from_numpy(rs.randint(0, 256, (2, h, w, 3), np.uint8))
    gt = synthetic_gt(np, torch, rs, 2, (h, w), device='cpu')
    names = [k for k, p in student.named_parameters() if p.requires_grad]
    parts = {'supervised': ('loss_cls', 'loss_bbox', 'loss_dfl'),
             'distillation': ('loss_dist_cls', 'loss_dist_bbox')}

    def run(dev):
        """Loss dict and, per part of the loss, the student's gradients."""
        s = copy.deepcopy(student).to(dev)
        t = copy.deepcopy(teacher).to(dev)
        batch = dict(images=images.to(dev), meta=stack_to(
            [ImageMeta.make((h, w), (h, w), (1.0, 1.0))] * 2, dev),
            gt=type(gt)(**{k: v.to(dev) for k, v in vars(gt).items()}))
        losses = det.loss(s, batch, teacher=t)
        params = dict(s.named_parameters())
        grads = {}
        for i, (part, keys) in enumerate(parts.items()):
            gs = torch.autograd.grad(
                sum(losses[k] for k in keys), [params[k] for k in names],
                retain_graph=i + 1 < len(parts), allow_unused=True)
            grads[part] = {k: (torch.zeros_like(params[k]) if g is None
                               else g).cpu() for k, g in zip(names, gs)}
        return ({k: float(v.detach()) for k, v in losses.items()}, grads)

    def ratio(a, b, keys):
        """||a - b|| / ||b|| over the named tensors together."""
        diff = torch.cat([(a[k] - b[k]).flatten() for k in keys])
        ref = torch.cat([b[k].flatten() for k in keys])
        return float(diff.norm() / ref.norm().clamp(min=1e-30))

    l_cpu, g_cpu = run('cpu')
    total_cpu = {k: sum(g_cpu[p][k] for p in parts) for k in names}

    def errors(l_dev, g_dev):
        """Every metric of the gate beside its limit."""
        total = {k: sum(g_dev[p][k] for p in parts) for k in names}
        per_tensor = sorted(((ratio(total, total_cpu, [k]),
                              float(total_cpu[k].norm()), k)
                             for k in names), reverse=True)
        return per_tensor, [
            ('loss', max(abs(l_dev[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
                         for k in l_cpu), 1e-3),
            ('whole gradient', ratio(total, total_cpu, names), 1e-3),
            *((f'{p} gradient', ratio(g_dev[p], g_cpu[p], names), 1e-3)
              for p in parts),
            ('per tensor', per_tensor[0][0], 1e-2)]

    def describe(metrics):
        return ', '.join(f'{name} {v:.2e} (limit {lim:g})'
                         for name, v, lim in metrics)

    l_gpu, g_gpu = run(DEV)
    per_tensor, metrics = errors(l_gpu, g_gpu)
    log(f'train reference: float32 ERD loss card {l_gpu}')
    log(f'train reference: float32 ERD loss CPU  {l_cpu}')
    log(f'train reference: card vs CPU, ||diff|| / ||g|| over all '
        f'{len(names)} trainable tensors: {describe(metrics)}; median ||g|| '
        f'of a tensor {sorted(e[1] for e in per_tensor)[len(names) // 2]:.3e}'
        f'; worst tensors:')
    for rel, norm, k in per_tensor[:5]:
        log(f'train reference:   {k}: ||diff||/||g|| {rel:.2e}, ||g|| '
            f'{norm:.3e}')
    check(all(np.isfinite(v) for v in l_gpu.values()), 'non-finite loss')
    check(l_cpu['loss_dist_cls'] > 0 and l_cpu['loss_dist_bbox'] > 0,
          'train reference: distillation is zero')
    check(all(np.isfinite(v) and v <= lim for _, v, lim in metrics),
          'the ERD loss or the student gradients on the card disagree with '
          'the CPU')

    class PlantedError(torch.autograd.Function):
        """Identity forward; the backward scales the gradient by 1.01."""

        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * 1.01

    def planted(fn):
        return lambda *a, **kw: tuple(PlantedError.apply(o)
                                      for o in fn(*a, **kw))

    for module, name in ((gfl_head_module, 'fused_gfl_loss'),
                         (gfl_erd_module, 'fused_erd_distill')):
        kernel = getattr(module, name)
        setattr(module, name, planted(kernel))
        try:
            _, metrics = errors(*run(DEV))
        finally:
            setattr(module, name, kernel)
        tripped = [m for m, v, lim in metrics if not v <= lim]
        log(f'train reference: control, {name} backward x 1.01: '
            f'{describe(metrics)}; over the limit: {tripped}')
        check(tripped, f'the gate passes a 1 % error in the {name} backward')


class SyntheticLoader:
    """erd_tpu's loader protocol over seeded random batches made on the
    card: uint8 images 800x1344 (the image 800x1333 inside the canvas),
    1-12 gt boxes in MAX_GT padded slots."""

    def __init__(self, np, torch, steps, seed=21):
        self.np, self.torch, self.steps, self.seed = np, torch, steps, seed
        self.cfg = type('LoaderConfig', (), {'batch_size': TRAIN_BATCH})()

    def steps_per_epoch(self, epoch):
        return self.steps

    def epoch(self, epoch):
        from erd_tpu_torch.structures import ImageMeta, stack_to
        np, torch = self.np, self.torch
        rs = np.random.RandomState(self.seed + epoch)
        gen = torch.Generator(device=DEV).manual_seed(self.seed + epoch)
        meta = stack_to([ImageMeta.make(TRAIN_IMAGE, TRAIN_IMAGE,
                                        (1.0, 1.0))] * TRAIN_BATCH, DEV)
        for _ in range(self.steps):
            images = torch.randint(0, 256, (TRAIN_BATCH,) + TRAIN_CANVAS +
                                   (3,), dtype=torch.uint8, device=DEV,
                                   generator=gen)
            yield dict(images=images, meta=meta, gt=synthetic_gt(
                np, torch, rs, TRAIN_BATCH, TRAIN_IMAGE))


def phase_train(np, torch, card):
    """build_trainer + fit of the ERD stage-2 GFL-R50 step at bs 16."""
    from erd_tpu_torch.apis import build_detector, build_trainer
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.engine import Hook, batch_to, resnet_frozen_paths
    from erd_tpu_torch.models.detectors.gfl_erd import erd_distill_losses
    from erd_tpu_torch.models.heads.gfl_head import (flatten_levels,
                                                     gfl_loss, gfl_targets)
    from erd_tpu_torch.ops import integral_decode, nms_sorted_keep
    from erd_tpu_torch.ops.erd_distill import fused_erd_distill
    from erd_tpu_torch.ops.ers_select import ers_select
    from erd_tpu_torch.ops.gfl_loss import fused_gfl_loss
    from erd_tpu_torch.task import atss_assign

    cfg = Config.fromfile(ERD_CONFIG)
    det = build_detector(cfg.model)
    check(type(det).__name__ == 'ERDDetector' and det.depth == 50 and
          det.num_classes == NUM_CLASSES and
          det.erd.ori_num_classes == OLD_CLASSES and
          det.compute_dtype == torch.bfloat16 and det.reg_max == 16,
          'not the ERD stage-2 GFL-R50 bf16 model')
    teacher = det.init_teacher(seed=1, device=DEV)
    student = det.init_student_from_teacher(2, teacher, device=DEV)
    frozen = resnet_frozen_paths(cfg.model.get('frozen_stages', 1))
    start = {k: v.clone() for k, v in student.state_dict().items()}
    teacher_start = {k: v.clone() for k, v in teacher.state_dict().items()}

    class StepTimer(Hook):
        def __init__(self):
            self.t, self.losses = [], []

        def before_train(self, trainer):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())

        def after_iter(self, trainer, step, losses):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())
            self.losses.append(losses)

    timer = StepTimer()
    cfg.train_cfg.epochs = 1
    loader = SyntheticLoader(np, torch, TRAIN_WARMUP + TRAIN_TIMED)
    trainer = build_trainer(cfg, det, loader, teacher=teacher, device=DEV)
    trainer.hooks.append(timer)
    counters = {'atss': atss_assign, 'gfl_loss': fused_gfl_loss,
                'ers_select': ers_select, 'erd_distill': fused_erd_distill,
                'nms_keep': nms_sorted_keep,
                'integral_decode': integral_decode}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    trainer.fit(student)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f'train: launches on the train path {launches}')
    for name, count in launches.items():
        check(count > 0, f'kernel {name} was not launched by the train path')

    steps = [t1 - t0 for t0, t1 in zip(timer.t, timer.t[1:])]
    timed = steps[TRAIN_WARMUP:]
    ips = TRAIN_BATCH * len(timed) / sum(timed)
    for i, (dt, losses) in enumerate(zip(steps, timer.losses)):
        log(f'train: step {i} {1e3 * dt:.1f} ms lr '
            f'{trainer.current_lr(i):.3e} ' +
            ' '.join(f'{k} {v:.5f}' for k, v in losses.items()))
        check(all(np.isfinite(v) for v in losses.values()),
              f'train: non-finite loss at step {i}')
        # step 0: the student widened from its teacher computes the
        # teacher's outputs on the old classes, so both terms are 0; from
        # the first update on they must not be
        check(i == 0 or (losses['loss_dist_cls'] > 0 and
                         losses['loss_dist_bbox'] > 0),
              f'train: distillation is zero at step {i}')

    state = student.state_dict()
    trainable = {n for n, p in student.named_parameters() if p.requires_grad}
    moved = {k for k, v in state.items() if not torch.equal(v, start[k])}
    check(not any(k.startswith(frozen) for k in moved),
          'train: a frozen-stage parameter changed')
    check(not any(k.startswith(frozen) for k in trainable),
          'train: a frozen-stage parameter is trainable')
    check(all(torch.equal(v, teacher_start[k])
              for k, v in teacher.state_dict().items()),
          'train: the teacher changed')
    weights = {k for k in trainable if state[k].dim() > 1}
    check(weights <= moved, 'train: a trainable weight did not move: ' +
          ', '.join(sorted(weights - moved)[:5]))
    log(f'train: {len(moved & trainable)}/{len(trainable)} trainable '
        f'tensors moved (every one of 2+ dims must; a norm scale may move '
        f'less than one float32 ulp at warm-up lr), 0 frozen or teacher '
        f'tensors changed')
    log(f'train: bs {TRAIN_BATCH} {TRAIN_CANVAS[0]}x{TRAIN_CANVAS[1]} bf16, '
        f'{len(timed)} timed steps ' +
        ' '.join(f'{1e3 * t:.1f}' for t in timed) +
        f' ms; {ips:.2f} img/s; peak memory {peak / 2**20:.0f} MiB; '
        f'card {card}')

    # stage times of one step, each ended by a synchronize
    batch = batch_to(next(iter(loader.epoch(1))), DEV)
    erd = det.erd
    stages = []

    def mark(name):
        torch.cuda.synchronize()
        stages.append((name, time.perf_counter()))

    opt = trainer.optimizer
    opt.zero_grad(set_to_none=True)
    mark('start')
    images = batch['images']
    ctx = det.anchor_context(images.shape[1:3])
    t_cls_lvl, t_reg_lvl = det.teacher.forward_raw(teacher, images)
    t_cls = flatten_levels(t_cls_lvl).float()
    t_reg = flatten_levels(t_reg_lvl).float()
    mark('teacher forward')
    s_cls_lvl, s_reg_lvl = det.forward_train(student, images)
    s_cls = flatten_levels(s_cls_lvl).float()
    s_reg = flatten_levels(s_reg_lvl).float()
    mark('student forward')
    targets = gfl_targets(ctx, batch['gt'], batch['meta'].img_shape,
                          NUM_CLASSES - OLD_CLASSES)
    mark('targets (ATSS)')
    losses = gfl_loss(ctx, s_cls[..., OLD_CLASSES:], s_reg, targets,
                      det.train_cfg)
    mark('GFL loss')
    l_cls, l_reg = erd_distill_losses(ctx.device_anchors(DEV), s_cls,
                                      s_reg, t_cls, t_reg, erd)
    total = sum(losses.values()) + l_cls.sum() + l_reg.sum()
    mark('distillation (ERS, decode, NMS, L2 + KD)')
    total.backward()
    mark('backward')
    opt.step()
    mark('optimizer')
    branch = erd_distill_losses.last_branch
    log(f'train: largest ERS reg selection of the step '
        f'{branch["selected"]}: the NMS ran on K = {branch["nms_k"]} '
        f'candidates per image')
    log('train: stage ms of one step: ' + ', '.join(
        f'{name} {1e3 * (t - stages[i][1]):.2f}'
        for i, (name, t) in enumerate(stages[1:])) +
        f'; total {1e3 * (stages[-1][1] - stages[0][1]):.2f}')
    del t_cls, t_reg, s_cls, s_reg, losses, total, l_cls, l_reg

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(student, batch, 100)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(ev, 'self_cuda_time_total', 0.0)
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    log(f'train profile: one step, wall {wall_ms:.1f} ms (profiled), device '
        f'kernels {busy:.1f} ms, device idle share '
        f'{max(0.0, 1 - busy / wall_ms):.3f}')
    for dev, count, key in sorted(rows, reverse=True)[:15]:
        log(f'train profile:   {dev:9.3f} ms  x{count:<5d} {key[:90]}')
    return launches


def frcnn_request(np, torch, hw):
    """One seeded RGB image of (H, W) through the test pipeline: (batch on
    the card, the image, the record)."""
    from erd_tpu_torch.data import DetPipeline, ImageRecord
    from erd_tpu_torch.structures import stack_to
    rs = np.random.RandomState(3)
    img = [rs.randint(0, 256, (h, w, 3), np.uint8) for h, w in REQUESTS][
        REQUESTS.index(hw)]
    rec = ImageRecord(0, '', hw[1], hw[0], np.zeros((0, 4), np.float32),
                      np.zeros((0,), np.int32), np.zeros((0,), bool))
    canvas, _, meta = DetPipeline()(rec, image=img)
    return dict(images=torch.from_numpy(canvas[None]).to(DEV),
                meta=stack_to([meta], DEV)), img


def arrange_fc_cls(torch, det, net, batch):
    """Seeded fc_cls weights: N(0, 1) scaled so that the class logits of
    one request's RoIs have std FC_CLS_STD, and a bias of FC_CLS_BOOST on
    FC_CLS_BOOSTED seeded classes (0 elsewhere and on the background).
    Each RoI then has several classes above score_thr, with distinct
    scores; with the init's N(0, 0.01) every class scores ~1/81 <
    score_thr and no candidate would reach the NMS."""
    fc = net.roi_head.bbox_head.fc_cls
    seen = []
    hook = fc.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    det.predict(net, batch)
    hook.remove()
    gen = torch.Generator().manual_seed(FC_CLS_SEED)
    w = torch.randn(fc.weight.shape, generator=gen).to(fc.weight.device)
    boosted = torch.randperm(NUM_CLASSES, generator=gen)[:FC_CLS_BOOSTED]
    std = float((seen[0].float() @ w.T).std())
    with torch.no_grad():
        fc.weight.copy_(w * (FC_CLS_STD / std))
        fc.bias.zero_()
        fc.bias[boosted.to(fc.bias.device)] = FC_CLS_BOOST


def capture(module, name, calls):
    """Replace ``module.name`` by a wrapper that records its arguments and
    calls the function. The function counts its launch on the module
    attribute it is bound to, now the wrapper, so captured calls are kept
    out of the main path's counts. Returns the restore function."""
    fn = getattr(module, name)

    def wrapper(*args):
        calls.append(args)
        return fn(*args)
    wrapper.launches = 0
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def roi_align_bytes(torch, feats, rois, levels):
    """Bytes RoIAlign must read from the maps for these RoIs: the distinct
    pixels its in-range samples touch, times the channels and the element
    size."""
    from erd_tpu_torch.ops.roi_align import _sample_axis
    total = 0
    c, esize = feats[0].shape[1], feats[0].element_size()
    for lvl, (f, stride) in enumerate(zip(feats, ROI_STRIDES)):
        r = rois[0][levels[0] == lvl]
        h, w = f.shape[2:]
        lo = r * (1.0 / stride) - 0.5
        size = (lo[:, 2:] - lo[:, :2]).clamp(min=1e-6) / torch.full_like(
            lo[:, :2], 7)
        in_y, y0, y1, _ = _sample_axis(lo[:, 1], size[:, 1], h, 7, 2)
        in_x, x0, x1, _ = _sample_axis(lo[:, 0], size[:, 0], w, 7, 2)
        hit = torch.zeros(h * w, dtype=torch.bool, device=f.device)
        ok = in_y[:, :, None] & in_x[:, None, :]
        for ya in (y0, y1):
            for xa in (x0, x1):
                hit[(ya[:, :, None] * w + xa[:, None, :])[ok]] = True
        total += int(hit.sum()) * c * esize
    return total


def phase_frcnn_kernels(np, torch):
    """RoIAlign, soft-NMS and the NMS at Faster R-CNN's sizes, on the
    arguments one 800x1333 request hands them, against their plain
    versions; then timed."""
    import importlib

    from erd_tpu_torch.apis import build_detector, init_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.ops import (map_roi_levels, nms_sorted_keep,
                                   nms_sorted_keep_plain, roi_align,
                                   roi_align_plain, soft_nms,
                                   soft_nms_plain)
    nms_module = importlib.import_module('erd_tpu_torch.ops.nms')
    roi_module = importlib.import_module('erd_tpu_torch.ops.roi_align')

    det, net, _ = init_detector(FRCNN_CONFIGS['nms'], device=DEV)
    check(type(det).__name__ == 'FasterRCNNDetector' and det.depth == 50 and
          det.num_classes == NUM_CLASSES and
          det.compute_dtype == torch.bfloat16,
          'not the Faster R-CNN R50 bf16 model')
    batch, _ = frcnn_request(np, torch, REQUESTS[-1])
    arrange_fc_cls(torch, det, net, batch)
    roi_calls, nms_calls, soft_calls = [], [], []
    restore = [capture(roi_module, 'roi_align', roi_calls),
               capture(nms_module, 'nms_sorted_keep', nms_calls)]
    try:
        det.predict(net, batch)
        det.test_cfg = build_detector(Config.fromfile(
            FRCNN_CONFIGS['soft_nms']).model).test_cfg
        restore.append(capture(nms_module, 'soft_nms', soft_calls))
        det.predict(net, batch)
    finally:
        for undo in restore:
            undo()
    torch.cuda.synchronize()
    check(len(roi_calls) == 2 and len(nms_calls) == 3 and
          len(soft_calls) == 1, 'unexpected kernel calls of one request')
    rows, nms_by_k = [], {}

    # -- RoIAlign: the 1000 proposals, the last 10 slots replaced by edge
    # cases (off-image, degenerate, zero, last row / column) and boxes of
    # levels 2 and 3, which random weights' proposals hardly reach
    feats, rois, _, strides = roi_calls[0][:4]
    rois = rois.clone()
    h, w = batch['images'].shape[1:3]
    rois[0, -10:] = torch.tensor([
        [-60, -40, -2, -1], [w + 5, 0, w + 90, 40], [10, 10, 10, 10],
        [0, 0, 0, 0], [30, 5, 29, 60], [w - 8, h - 8, w + 4, h + 4],
        [w - 4, 0, w, h], [0, h - 4, w, h], [-9, -9, 600, 500],
        [100, 100, 400, 400]], device=DEV)
    levels = map_roi_levels(rois, 4).contiguous()
    cpu_levels = map_roi_levels(rois.cpu(), 4)
    check(torch.equal(levels.cpu(), cpu_levels),
          'RoI levels differ between card and CPU')
    got = roi_align(feats, rois, levels, strides)
    torch.cuda.synchronize()
    want = roi_align_plain(feats, rois, levels, strides)
    feat_max = max(float(f.float().abs().max()) for f in feats)
    roi_err = float((got - want).abs().max())
    per_level = torch.bincount(levels.flatten().long(), minlength=4)
    log(f'frcnn kernels: roi_align R={rois.shape[1]} C={feats[0].shape[1]} '
        f'{feats[0].dtype} levels {per_level.tolist()} sizes '
        f'{[tuple(f.shape[2:]) for f in feats]}: max_abs_err={roi_err:.3e} '
        f'(limit 1e-6*max|feat| = {1e-6 * feat_max:.3e})')
    check(roi_err <= 1e-6 * feat_max, 'RoIAlign kernel disagrees with plain')
    check(bool((per_level > 0).all()), 'RoIAlign check missed a level')
    args = (feats, rois, levels, strides)
    ms, call_ms, src, plain_ms = time_pair(
        torch, lambda: roi_align(*args), lambda: roi_align_plain(*args),
        ['roi_align_kernel'], n=20)
    r, c = rois.shape[1], feats[0].shape[1]
    nbytes = roi_align_bytes(torch, feats, rois, levels) + \
        r * c * 49 * 4 + r * (16 + 4)
    ops = r * c * 49 * 48.0  # per output: 4 samples x (8 mul, 3 add) + 3
    # adds + 1 divide (the sample coordinates are per RoI and bin)
    bms, by = bound_of(nbytes, ops)
    rows.append(dict(name='roi_align', route='cuda',
                     source='erd_tpu_torch/csrc/roi_align.cu',
                     replaces='erd_tpu/ops/roi_align.py:92',
                     max_abs_err=roi_err, ms=ms, call_ms=call_ms,
                     ms_from=src, plain_ms=plain_ms, bound_ms=bms,
                     bound_by=by, library_ms=None))

    # -- soft-NMS on the captured call, linear (the config) and gaussian
    sboxes, scores, steps = soft_calls[0][:3]
    k = sboxes.shape[1]
    check(k == 2000 and steps == 100, f'soft-NMS call at K={k}, '
          f'{steps} steps, expected 2000 and 100')
    for method in ('linear', 'gaussian'):
        gi, gs = soft_nms(sboxes, scores, steps, 0.5, 0.5, 1e-3, method)
        torch.cuda.synchronize()
        wi, ws = soft_nms_plain(sboxes, scores, steps, 0.5, 0.5, 1e-3,
                                method)
        # compared up to the first step whose selection differs (none, or
        # a tie of two decayed scores to 1e-6, for the gaussian decay)
        same = (gi == wi)[0]
        first = steps if bool(same.all()) else int((~same).int().argmax())
        upto = slice(0, min(first + 1, steps))
        live = ws[0, upto] > float('-inf')
        rel = float(((gs[0, upto] - ws[0, upto]).abs() /
                     ws[0, upto].abs())[live].max())
        log(f'frcnn kernels: soft_nms {method} K={k} steps={steps} kept '
            f'{int((ws >= 1e-3).sum())}: selections equal over '
            f'{first} of {steps} steps, scores bit-equal '
            f'{torch.equal(gs, ws)}, max rel err {rel:.2e}')
        if method == 'linear':
            check(first == steps and torch.equal(gs, ws),
                  'linear soft-NMS kernel is not bit-exact with plain')
        else:
            check(rel <= 1e-6, 'gaussian soft-NMS scores differ > 1e-6 '
                  'relative, or selections differ without a tie')
    sargs = (sboxes, scores, steps, 0.5, 0.5, 1e-3, 'linear')
    ms, call_ms, src, plain_ms = time_pair(
        torch, lambda: soft_nms(*sargs), lambda: soft_nms_plain(*sargs),
        ['soft_nms_kernel'], n=20)
    nbytes = k * (16 + 4) + steps * (8 + 4)
    ops = steps * k * 21.0  # per step and candidate: argmax compare; IoU
    # (2 min, 2 max, 2 sub, 2 max0, mul, add, sub, max, div); decay compare,
    # sub, mul; min-score compare
    bms, by = bound_of(nbytes, ops)
    rows.append(dict(name='soft_nms', route='cuda',
                     source='erd_tpu_torch/csrc/soft_nms.cu',
                     replaces='erd_tpu/ops/nms.py:170', max_abs_err=0.0,
                     ms=ms, call_ms=call_ms, ms_from=src, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=None))

    # -- the NMS kernel on the RPN call and the R-CNN call
    for nargs, want_k, want_thr in ((nms_calls[0], 4819, 0.7),
                                    (nms_calls[1], 2000, 0.5)):
        kk, thr = nargs[0].shape[1], nargs[3]
        check(kk == want_k and abs(thr - want_thr) < 1e-9,
              f'NMS call at K={kk}, IoU {thr}; expected {want_k}, {want_thr}')
        got = nms_sorted_keep(*nargs)
        torch.cuda.synchronize()
        mism = int((got != nms_sorted_keep_plain(*nargs)).sum())
        call_ms = events_ms(torch, lambda: nms_sorted_keep(*nargs), 20)
        dev_ms = kernel_ms(torch, lambda: nms_sorted_keep(*nargs),
                           ['nms_mask_kernel', 'nms_reduce_kernel'], 20)
        nms_by_k[kk] = dict(iou=thr, ms=dev_ms or call_ms, call_ms=call_ms,
                            valid=int(nargs[1].sum()), kept=int(got.sum()))
        log(f'frcnn kernels: nms K={kk} iou={thr} valid '
            f'{int(nargs[1].sum())} kept {int(got.sum())} mismatches={mism} '
            f'(exact); {nms_by_k[kk]["ms"]:.4f} ms device, {call_ms:.4f} ms '
            f'per call')
        check(mism == 0, f'NMS kernel disagrees with plain at K={kk}')
    log('frcnn kernels: library_ms is null for both: no single PyTorch call '
        'computes multi-level RoIAlign or soft-NMS (no torchvision)')
    del roi_calls, nms_calls, soft_calls, feats, got, want, net
    torch.cuda.empty_cache()
    return rows, nms_by_k


def phase_frcnn_reference(np, torch):
    """Full-width float32 Faster R-CNN network (backbone, FPN, RPN, the
    head on zero RoIs), card vs CPU, on one small input."""
    import copy

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    cfg = Config.fromfile(FRCNN_CONFIGS['nms'])
    cfg.model.compute_dtype = 'float32'
    det = build_detector(cfg.model)
    net_cpu = det.init(seed=1, device='cpu')
    net_gpu = copy.deepcopy(net_cpu).to(DEV)
    img = np.random.RandomState(2).randint(0, 256, (1, 128, 192, 3),
                                           np.uint8)
    (w_cls, w_reg), w_head = det.forward_raw(net_cpu, torch.from_numpy(img))
    (g_cls, g_reg), g_head = det.forward_raw(net_gpu,
                                             torch.from_numpy(img).to(DEV))
    worst = 0.0
    for g, w in zip(g_cls + g_reg + list(g_head), w_cls + w_reg +
                    list(w_head)):
        check(tuple(g.shape) == tuple(w.shape), 'reference shape mismatch')
        worst = max(worst, float((g.cpu() - w).abs().max() / w.abs().max()))
    log(f'frcnn reference: float32 network card vs CPU, max |diff| / max '
        f'|out| = {worst:.2e} (tolerance 1e-3)')
    check(worst <= 1e-3, 'float32 Faster R-CNN on the card disagrees with '
          'the CPU')


def phase_frcnn_serve(np, torch, card):
    """init_detector / inference_detector of both Faster R-CNN configs on
    the 4 requests; stage times, idle share, card-vs-CPU post-processing."""
    from erd_tpu_torch.apis import inference_detector, init_detector
    from erd_tpu_torch.data import DetPipeline, ImageRecord
    from erd_tpu_torch.ops import nms_sorted_keep, roi_align, soft_nms
    from erd_tpu_torch.structures import stack_to

    phase_frcnn_reference(np, torch)
    rs = np.random.RandomState(3)
    images = [rs.randint(0, 256, (h, w, 3), np.uint8) for h, w in REQUESTS]
    counters = {'roi_align': roi_align, 'nms_keep': nms_sorted_keep,
                'soft_nms': soft_nms}
    launches = {k: 0 for k in counters}
    for kind, path in FRCNN_CONFIGS.items():
        tag = f'frcnn serve {kind}'
        det, net, _ = init_detector(path, device=DEV)
        check(type(det).__name__ == 'FasterRCNNDetector' and
              det.test_cfg.nms_type == kind and
              det.compute_dtype == torch.bfloat16,
              f'{path} is not the Faster R-CNN bf16 model with {kind}')
        batch, _ = frcnn_request(np, torch, REQUESTS[-1])
        arrange_fc_cls(torch, det, net, batch)
        inference_detector(det, net, images)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        results, latency = [], []
        for img in images:
            t0 = time.perf_counter()
            results.append(inference_detector(det, net, img))
            torch.cuda.synchronize()
            latency.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        counts = {k: fn.launches for k, fn in counters.items()}
        log(f'{tag}: launches on the main path {counts}')
        for name, count in counts.items():
            want = len(images) * (2 if name == 'nms_keep' and kind == 'nms'
                                  else 1)
            if name == 'soft_nms' and kind == 'nms':
                want = 0
            check(count == want, f'{tag}: kernel {name} launched {count} '
                  f'times, expected {want}')
            launches[name] += count

        pipe = DetPipeline()
        for i, (img, res) in enumerate(zip(images, results)):
            h, w = img.shape[:2]
            n = len(res.scores)
            check(0 < n <= 100, f'{tag} request {i}: {n} detections')
            check(np.isfinite(res.bboxes).all() and
                  np.isfinite(res.scores).all(),
                  f'{tag} request {i}: non-finite output')
            slack = 1e-3 * max(h, w)
            check((res.bboxes >= -slack).all() and
                  (res.bboxes[:, [0, 2]] <= w + slack).all() and
                  (res.bboxes[:, [1, 3]] <= h + slack).all(),
                  f'{tag} request {i}: boxes outside the image')
            check(((res.labels >= 0) & (res.labels < NUM_CLASSES)).all(),
                  f'{tag} request {i}: labels out of range')
            rec = ImageRecord(i, '', w, h, np.zeros((0, 4), np.float32),
                              np.zeros((0,), np.int32), np.zeros((0,), bool))
            marks = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            canvas, _, meta = pipe(rec, image=img)
            images_dev = torch.from_numpy(canvas[None]).to(DEV)
            meta_dev = stack_to([meta], DEV)
            mark()
            feats, rpn_cls, rpn_reg = det.feats_and_rpn(net, images_dev)
            mark()
            ctx = det.anchor_context(images_dev.shape[1:3])
            rois, _, roi_mask = det.proposals(ctx, rpn_cls, rpn_reg,
                                              meta_dev)
            mark()
            roi_feats = det.roi_feats(feats, rois)
            mark()
            cls, reg = det.roi_forward(net, roi_feats)
            mark()
            gpu = det.postprocess(cls, reg, rois, roi_mask, meta_dev)
            mark()
            names = ('host pipeline + upload', 'network', 'RPN proposals',
                     'RoIAlign', 'head', 'post-processing')
            log(f'{tag}: request {i} stages ms: ' + ', '.join(
                f'{name} {1e3 * (t1 - t0):.2f}' for name, t0, t1 in
                zip(names, marks, marks[1:])))
            cpu = det.postprocess(cls.cpu(), reg.cpu(), rois.cpu(),
                                  roi_mask.cpu(), stack_to([meta], 'cpu'))
            cand = int(gpu.num_candidates[0])
            box_err = float((gpu.bboxes.cpu() - cpu.bboxes).abs().max())
            score_err = float((gpu.scores.cpu() - cpu.scores).abs().max())
            log(f'{tag}: request {i} image {h}x{w} canvas {canvas.shape[0]}x'
                f'{canvas.shape[1]} proposals {int(roi_mask.sum())} '
                f'candidates_into_nms={cand} detections={n} card_vs_cpu '
                f'max_box_err={box_err:.2e}px max_score_err={score_err:.2e}')
            check(cand >= 2000, f'{tag} request {i}: {cand} candidates '
                  f'reached the NMS, fewer than 2000')
            check(cand == int(cpu.num_candidates[0]),
                  f'{tag} request {i}: candidate count differs on the CPU')
            check(torch.equal(gpu.mask.cpu(), cpu.mask) and
                  torch.equal(gpu.labels.cpu(), cpu.labels),
                  f'{tag} request {i}: card and CPU detections differ')
            check(box_err <= 1e-2 and score_err <= 1e-6,
                  f'{tag} request {i}: card and CPU boxes/scores differ')
            check(int(gpu.mask.sum()) == n,
                  f'{tag} request {i}: predict and inference_detector '
                  f'disagree')
            del feats, roi_feats
        profile_request(torch, lambda: inference_detector(det, net,
                                                          images[-1]), tag)
        total = sum(latency)
        log(f'{tag}: warm per-request latency ms ' +
            ' '.join(f'{1e3 * t:.2f}' for t in latency) +
            f'; {len(latency) / total:.2f} img/s; peak memory '
            f'{peak / 2**20:.1f} MiB; card {card}')
        del det, net
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f'chip_smoke: {e}', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, 'erd_tpu_torch')):
        print('chip_smoke: erd_tpu_torch/ not found beside chip_smoke.py',
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # Triton's cache inside the checkout's ignored build directory
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(
        ROOT, 'erd_tpu_torch', 'csrc', 'build', 'triton'))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from erd_tpu_torch.ops import cuda_build
        card = card_line()
        print(card, flush=True)
        log(f'card: {torch.cuda.get_device_name(0)}; torch '
            f'{torch.__version__}, CUDA {torch.version.cuda}; '
            f'cudnn.allow_tf32=False, matmul.allow_tf32=False')

        t0 = time.perf_counter()
        cuda_build.build()
        log(f'build: {len(cuda_build.SOURCES)} kernels in '
            f'{time.perf_counter() - t0:.1f}s')
        for name, text in cuda_build.BUILD_LOGS.items():
            for line in text.splitlines():
                if 'registers' in line or 'spill' in line:
                    log(f'build: {name}: {line.strip()}')

        kernels = phase_kernels(np, torch)
        phase_reference(np, torch)
        serve_launches = phase_serve(np, torch, card)
        train_rows, train_extra, no_clip_err = phase_train_kernels(np,
                                                                   torch)
        phase_train_reference(np, torch)
        train_launches = phase_train(np, torch, card)
        frcnn_rows, frcnn_nms = phase_frcnn_kernels(np, torch)
        frcnn_launches = phase_frcnn_serve(np, torch, card)
        for row in kernels:  # nms_keep and integral_decode: both paths
            by_path = {'serve': serve_launches[row['name']],
                       'train': train_launches[row['name']]}
            if row['name'] == 'nms_keep':
                by_path['frcnn serve'] = frcnn_launches['nms_keep']
                row['frcnn_ms_by_k'] = frcnn_nms
            row['launches'] = sum(by_path.values())
            row['launches_by_path'] = by_path
            idx = 1 if row['name'] == 'nms_keep' else 0
            row['train_ms_by_k'] = {k: v[idx] for k, v in train_extra.items()}
            if row['name'] == 'integral_decode':
                row['train_no_clip_max_abs_err'] = no_clip_err
        for row in train_rows:
            row['launches'] = train_launches[row['name']]
            row['launches_by_path'] = {'train': row['launches']}
        for row in frcnn_rows:
            row['launches'] = frcnn_launches[row['name']]
            row['launches_by_path'] = {'frcnn serve': row['launches']}
        kernels += train_rows + frcnn_rows
        for row in kernels:
            row['card'] = card
    except Exception:  # report any failure, exit non-zero, no result line
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
