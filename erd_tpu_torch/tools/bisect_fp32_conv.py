"""Fault 3.10's bisect (ROADMAP.md section 3) on one CUDA GPU: where the
card's float32 gradient of Mask R-CNN's mask loss over backbone + neck
parts from a float64 run. Run from the repository root:

    python3 -m erd_tpu_torch.tools.bisect_fp32_conv

1. Conv chains (CASES), forward and backward, in float32 by three routes
   against the same chain in float64, all on the card: ``cudnn`` (the
   port's ``conv2d_ieee``: cuDNN at IEEE float32, its own algorithm
   choice), ``no cudnn`` (``torch.backends.cudnn.flags(enabled=False)``:
   torch's own im2col + GEMM) and ``direct`` (``direct_conv``: unfold +
   IEEE float32 matmul, no cuDNN algorithm). For each: the worst tensor's
   ||diff|| / ||ref||, the device ms of one forward + backward, the FFT
   kernels' device ms and the top kernels as the profiler names them.
2. chip_smoke.py's Mask R-CNN train reference step (float32, 2 images
   128x192): the card's mask gradient over backbone + neck against a
   float64 CPU run, as the port runs it, with RoIAlign's backward kernel
   replaced by its plain version, with cuDNN off, and with every 3x3
   unit-stride float32 conv on the ``direct`` route.

Prints a line per measurement and, last, one JSON object of them all. A
diagnosis, not a check: every route is float32 at IEEE precision, and only
non-finite errors fail.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import sys

import torch
import torch.nn.functional as F

from ..utils import conv2d_ieee, matmul_fp32_precision

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROUTES = ('cudnn', 'no cudnn', 'direct')
# (input shape, the chain's conv weights)
CASES = {
    # the four 3x3 convs of Mask R-CNN's mask head at a bs-16 step's RoIs
    'mask head (8192, 256, 14, 14), 4 x 3x3': (
        (8192, 256, 14, 14), [(256, 256, 3, 3)] * 4),
    # one R50 layer3 bottleneck at the train reference's input (2 images
    # 128x192) and at a bs-2 800x1344 step
    'layer3 block (2, 1024, 8, 12)': (
        (2, 1024, 8, 12), [(256, 1024, 1, 1), (256, 256, 3, 3),
                           (1024, 256, 1, 1)]),
    'layer3 block (2, 1024, 50, 84)': (
        (2, 1024, 50, 84), [(256, 1024, 1, 1), (256, 256, 3, 3),
                            (1024, 256, 1, 1)])}


def direct_conv(x, w, pad):
    """F.conv2d (stride 1, no bias) as a direct sum: im2col columns times
    the weight, IEEE float32 GEMMs in chunks of at most 1 GiB of columns,
    its input and weight gradients by the same route."""
    k = w.shape[-2:]

    def chunks(n, per_image):
        step = max(1, (1 << 30) // per_image)
        return range(0, n, step), step

    class Direct(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            n, co = x.shape[0], w.shape[0]
            wm = w.reshape(co, -1)
            out = x.new_empty((n, co, x.shape[2] * x.shape[3]))
            starts, step = chunks(n, wm.shape[1] * out.shape[2] * 4)
            with matmul_fp32_precision('ieee'):
                for i in starts:
                    out[i:i + step] = torch.matmul(wm, F.unfold(
                        x[i:i + step], k, padding=pad))
            return out.view(n, co, *x.shape[2:])

        @staticmethod
        def backward(ctx, grad):
            x, w = ctx.saved_tensors
            n, co = x.shape[0], w.shape[0]
            wm = w.reshape(co, -1)
            g = grad.reshape(n, co, -1)
            gx, gw = torch.empty_like(x), torch.zeros_like(wm)
            starts, step = chunks(n, wm.shape[1] * g.shape[2] * 4)
            with matmul_fp32_precision('ieee'):
                for i in starts:
                    gi = g[i:i + step]
                    gx[i:i + step] = F.fold(torch.matmul(wm.t(), gi),
                                            x.shape[2:], k, padding=pad)
                    cols = F.unfold(x[i:i + step], k, padding=pad)
                    gw += torch.matmul(gi.transpose(0, 1).reshape(co, -1),
                                       cols.transpose(0, 1).reshape(
                                           wm.shape[1], -1).t())
            return gx, gw.view(w.shape)
    return Direct.apply(x, w)


def conv_chain(x, ws, route):
    """Stride-1 convs (padding k // 2, ReLU between) on ``x`` by one of
    ROUTES; 'no cudnn' expects the caller to have turned cuDNN off."""
    out = x
    for i, w in enumerate(ws):
        pad = (w.shape[-1] // 2,) * 2
        if route == 'direct':
            out = direct_conv(out, w, pad)
        elif route == 'no cudnn':
            out = F.conv2d(out, w, None, 1, pad)
        else:
            out = conv2d_ieee(out, w, None, (1, 1), pad)
        if i < len(ws) - 1:
            out = torch.relu(out)
    return out


def route_errors(shape, weights, seed):
    """Each route's float32 chain against the float64 chain (cudnn) on the
    card: {route: dict(err, worst, ms, fft_ms, top)}."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=gen))
    ws = [torch.randn(s, generator=gen) * math.prod(s[1:]) ** -0.5
          for s in weights]
    r = torch.randn((shape[0], weights[-1][0]) + shape[2:], generator=gen)
    tensors = ['output', 'input gradient'] + [
        f'weight {i} gradient' for i in range(len(ws))]

    def run(route, x, ws, r):
        x = x.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in ws]
        ctx = torch.backends.cudnn.flags(enabled=False) \
            if route == 'no cudnn' else contextlib.nullcontext()
        with ctx:
            out = conv_chain(x, ws, route)
            grads = torch.autograd.grad(out, [x] + ws, r)
        return [out.detach()] + list(grads)

    def on_card(dtype):
        return (x.to('cuda', dtype), [w.to('cuda', dtype) for w in ws],
                r.to('cuda', dtype))

    want = run('cudnn', *on_card(torch.float64))
    args = on_card(torch.float32)
    results = {}
    for route in ROUTES:
        errs = [float((g.double() - e).norm() / e.norm())
                for g, e in zip(run(route, *args), want)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in 'se')
        start.record()
        run(route, *args)
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(route, *args)
            torch.cuda.synchronize()
        rows = sorted(((getattr(e, 'self_device_time_total', 0.0), e.key)
                       for e in prof.key_averages()), reverse=True)
        worst = max(range(len(errs)), key=errs.__getitem__)
        results[route] = dict(
            err=errs[worst], worst=tensors[worst],
            ms=start.elapsed_time(end),
            fft_ms=sum(t for t, k in rows if 'fft' in k.lower() or
                       'cf32' in k.lower()) / 1e3,
            top=[f'{k[:64]} {t / 1e3:.1f}ms' for t, k in rows[:3] if t > 0])
        torch.cuda.empty_cache()
    del want, args
    torch.cuda.empty_cache()
    return results


def direct_3x3(original):
    """A stand-in for ``erd_tpu_torch.utils._IEEEConv2d`` that sends every
    3x3 unit-stride float32 conv on the card to ``direct_conv``."""
    class Route:
        @staticmethod
        def apply(x, weight, bias, stride, padding, transposed):
            if transposed or stride != (1, 1) or not x.is_cuda or \
                    weight.shape[-2:] != (3, 3) or x.dtype != torch.float32:
                return original.apply(x, weight, bias, stride, padding,
                                      transposed)
            out = direct_conv(x, weight, padding)
            return out if bias is None else out + bias.view(1, -1, 1, 1)
    return Route


def step_errors():
    """The Mask R-CNN train reference's card-vs-float64 ratio under each
    variant (chip_smoke.phase_mask_train_reference, its gates included)."""
    import numpy as np
    sys.path.insert(0, ROOT)
    smoke = importlib.import_module('chip_smoke')
    roi_module = importlib.import_module('erd_tpu_torch.ops.roi_align')
    utils = importlib.import_module('erd_tpu_torch.utils')

    def plain_roi_backward(_):
        def stand_in(grad, rois, levels, shapes, strides, dtype, out_size,
                     sampling_ratio):
            return [g.to(dtype) for g in roi_module.roi_align_backward_plain(
                grad, rois, levels, shapes, strides, out_size,
                sampling_ratio)]
        return stand_in
    variants = {
        'as the port runs it': contextlib.nullcontext,
        'RoIAlign backward plain': lambda: smoke.patched(
            roi_module, 'roi_align_backward', plain_roi_backward),
        'cuDNN off': lambda: torch.backends.cudnn.flags(enabled=False),
        '3x3 convs direct': lambda: smoke.patched(utils, '_IEEEConv2d',
                                                  direct_3x3)}
    out = {}
    for label, ctx in variants.items():
        with ctx():
            off64 = smoke.phase_mask_train_reference(np, torch,
                                                     kinds=('mask_rcnn',))
        out[label] = off64['card']
        print(f'bisect: mask_rcnn step, {label}: the card\'s mask gradient '
              f'over backbone + neck against float64 {out[label]:.2e} (CPU '
              f'float32 {off64["cpu"]:.2e})', flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('bisect_fp32_conv: CUDA is not available', file=sys.stderr)
        return 1
    report = {'card': torch.cuda.get_device_name(0), 'conv': {}}
    for seed, (case, (shape, weights)) in enumerate(CASES.items()):
        res = route_errors(shape, weights, seed)
        for route, v in res.items():
            print(f'bisect: {case}: {route}: float32 vs float64 worst '
                  f'||diff||/||ref|| {v["err"]:.2e} ({v["worst"]}), '
                  f'fwd+bwd {v["ms"]:.1f} ms, FFT kernels {v["fft_ms"]:.1f} '
                  f'ms; top kernels: {"; ".join(v["top"])}', flush=True)
        report['conv'][case] = res
    report['step'] = step_errors()
    print(json.dumps(report))
    finite = [v['err'] for res in report['conv'].values()
              for v in res.values()] + list(report['step'].values())
    return 0 if all(math.isfinite(e) for e in finite) else 1


if __name__ == '__main__':
    sys.exit(main())
