#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (erd_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:
  1. card       the nvidia-smi name and power-limit line;
  2. build      nvcc builds every kernel of erd_tpu_torch/csrc/, in parallel;
  3. kernels    each kernel against its plain PyTorch version on the card at
                serving shapes (NMS keep masks exactly equal; the decode
                within 1e-4 * stride + 1e-5 * |box| px), then timed;
  4. reference  the full-width float32 network on the card against the same
                network on the CPU, on a small input;
  5. serve      4 requests through init_detector / inference_detector of the
                ERD stage-2 GFL-R50 detector (80 classes, bf16, seeded
                random weights, gfl_cls bias 0) on both canvases; every
                kernel of the path must have launched; the same head outputs
                post-processed on the CPU must give the same detections;
  6. the {"kernels": [...]} line, then the {"ok": true, ...} line.

TF32 is off for both cuDNN and matmuls: the served model computes in bf16,
and the float32 reference compares full-precision float32 on both devices.
The script imports neither JAX nor erd_tpu.
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
# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# the four requests: (H, W) of seeded random RGB images
REQUESTS = [(480, 640), (640, 480), (427, 640), (800, 1333)]
NUM_CLASSES = 80


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


def profile_request(torch, fn):
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
    log(f'profile: one 800x1333 request, wall {wall_ms:.2f} ms (profiled), '
        f'device kernels {busy:.2f} ms, device idle share '
        f'{max(0.0, 1 - busy / wall_ms):.3f}')
    for dev, count, key in sorted(rows, reverse=True)[:10]:
        log(f'profile:   {dev:8.3f} ms  x{count:<4d} {key[:90]}')


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
        launches = phase_serve(np, torch, card)
        for row in kernels:
            row['launches'] = launches[row['name']]
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
