"""Where the redesigned kernels and the atomic backward kernels spend
their time, on one CUDA GPU: the deformable im2col backward
(``erd_deform_im2col_backward``, kernel 8b), the multi-scale deformable
attention backward and forward (kernels 9b and 9), the RoIAlign backward
(7b), and the call times of the CARAFE (10b) and corner-pool (12a-b)
backwards. Run from the repository root:

    python3 -m erd_tpu_torch.tools.atomic_backward_probe [--only 9,7b]

The calls are those of one bs-16, 800x1344 bf16 training step, captured as
``chip_smoke.py``'s train-kernel phases capture them (seeded networks,
conv_offset and sampling weights arranged):

1. 8b, every distinct call shape of a GFL R101-DCN and a VFNet R50-mdconv
   step, timed (CUDA events around the call, less the zeroing of the map
   gradient) and summed over the step. At the VFNet P3 head call (bf16
   256 x 100 x 168) and an R101 layer3 call (bf16 256 x 50 x 84): the
   call with its offsets set to zero, with ``need_x=False`` (no atomics at
   all) and with ``need_offset=False`` (the map gradient alone); and the
   offsets' reach: the share of samples within m pixels of their base
   point, and the rows x columns that a tile's samples' corners span.
   At every call shape, the kernel on map-gradient chunks of all the
   group's channels, 64, 32 and 16 (the plan, ``deform_backward_chunk``,
   picks one of them). At the two headline calls, the tiled design that
   stages a window of the map in shared memory
   (``csrc/deform_backward_window.cu``, on no path), held to the plain
   version and timed on tiles of 8 x 32 and 4 x 64.
2. 9b, the encoder call (Q = 22323) and each config's decoder call, timed
   the same way less the zeroing of the value gradient. At the encoder
   call: only level l's samples live (the other levels' locations moved
   off their maps, where they read and add nothing), for each l; and every
   sample on maps of level l's size (four copies of that level, one per
   level slot, so that each row takes the adds a row of level l takes on
   the path, from four times as many samples); with the adds a row takes
   on each level.
3. 9, the forward (``erd_ms_deform_attn``), at every call shape of one
   DINO and one Deformable DETR step, each step's sum, and the encoder
   call on the step's first image alone (the serving shape): by events
   around the calls, and by CUDA-graph replays (device time without the
   host's launch gaps, which events see at the small decoder calls).
4. 7b, the RoIAlign backward (``erd_roi_align_backward``), at every call
   of one Faster R-CNN, Mask R-CNN and PointRend step (the out-7 box call;
   the out-14 mask call): the call by CUDA events; its three device
   operations (the scratch's memset, the kernel, the rounding pass) by
   ``torch.profiler``; the share of the maps' 32-pixel tiles whose
   gradient is nonzero; and the kernel with its float4 atomic adds
   replaced by plain stores (geometry, reads and the scratch's traffic
   left), compiled from a copy of ``csrc/roi_align.cu`` edited in the
   build directory, on no path.
5. others: the call time of the CARAFE backward (10b) at the 3 calls of
   one FPN-CARAFE step and of the corner-pool backward (12a-b) in the 4
   directions of one CornerNet step.

``--only 9,7b`` runs the named parts alone, in that order (the parts: 8b,
9b, 9, 7b, others).

Prints a line per measurement and, last, one JSON object of them all.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REACH = (0, 1, 2, 3, 4, 6, 8, 10, 12, 16)
TILES = ((8, 32), (16, 32), (8, 16))
CHUNKS = (64, 32, 16)
# the window design's tiles, margin and the blocks an SM its shared memory
# is sized for (227 KB a block, 228 KB an SM on an H100)
WINDOW_TILES, WINDOW_MARGIN, WINDOW_BLOCKS_PER_SM = ((8, 32), (4, 64)), 4, 6
SHARED_BYTES_PER_SM = 233472


def captured_calls(smoke, module, name, net_fn, kinds, key_fn,
                   batch_fn=None):
    """{kind: {key: [args, count]}}: the first call of each key of one
    training step of each config, and how many calls share the key.
    ``batch_fn(kind)`` gives a config's batch on the card (default: the
    bs-16, 800x1344 train batch of ``chip_smoke.SyntheticLoader``)."""
    import numpy as np

    from erd_tpu_torch.engine import batch_to
    out = {}
    for kind in kinds:
        _, det, net = net_fn(torch, kind)
        batch = batch_fn(kind) if batch_fn else batch_to(next(iter(
            smoke.SyntheticLoader(np, torch, 1, seed=41,
                                  num_labels=smoke.NUM_CLASSES).epoch(0))),
            smoke.DEV)
        calls = {}
        fn = getattr(module, name)

        def wrapper(*args):
            key = key_fn(args)
            if key in calls:
                calls[key][1] += 1
            else:
                calls[key] = [tuple(a.detach() if torch.is_tensor(a) else a
                                    for a in args), 1]
            return fn(*args)
        wrapper.launches = 0
        setattr(module, name, wrapper)
        try:
            losses = det.loss(net, batch)
            sum(losses.values()).backward()
        finally:
            setattr(module, name, fn)
        torch.cuda.synchronize()
        del net, losses, batch
        torch.cuda.empty_cache()
        out[kind] = calls
    return out


def kernel_ms(smoke, fn, zero_shape, n=5):
    """(ms less the zeroing, call ms) by CUDA events."""
    call = smoke.events_ms(torch, fn, n)
    zero = smoke.events_ms(torch, lambda: torch.zeros(
        zero_shape, dtype=torch.float32, device=smoke.DEV), n)
    return call - zero, call


def offset_reach(args):
    """The share of samples with max(|dy|, |dx|) <= m for m in REACH, and
    per tile size the rows x columns its samples' corners span (clamped to
    the map and its border row and column): median, 90th percentile and
    largest."""
    from erd_tpu_torch.ops.deform_conv import _base_grid
    x, offset, _, _, k, stride, pad, dil, dg = args[:9]
    b, _, h, w = x.shape
    ho, wo = offset.shape[2:]
    off = offset.reshape(b, dg, k * k, 2, ho, wo)
    reach = off.abs().amax(3)
    share = {m: float((reach <= m).float().mean()) for m in REACH}
    by, bx = _base_grid(ho, wo, k, stride, pad, dil, x.device)
    y0 = torch.floor(by + off[:, :, :, 0]).clamp(-1, h - 1)
    x0 = torch.floor(bx + off[:, :, :, 1]).clamp(-1, w - 1)
    spans = {}
    for th, tw in TILES:
        ty, tx = -(-ho // th), -(-wo // tw)

        def tiled(t, fill):
            t = torch.nn.functional.pad(t, (0, tx * tw - wo, 0, ty * th - ho),
                                        value=fill)
            return t.reshape(b, dg, k * k, ty, th, tx, tw).permute(
                0, 1, 3, 5, 2, 4, 6).reshape(b * dg * ty * tx, -1)
        big = float(1 << 20)
        rows = tiled(y0, -big).amax(1) + 2 - tiled(y0, big).amin(1)
        cols = tiled(x0, -big).amax(1) + 2 - tiled(x0, big).amin(1)
        area = (rows * cols).float()
        spans[f'{th}x{tw}'] = dict(
            rows=[float(rows.float().quantile(q)) for q in (0.5, 0.9, 1.0)],
            cols=[float(cols.float().quantile(q)) for q in (0.5, 0.9, 1.0)],
            area_over_tile=[float(area.quantile(q)) / (th * tw)
                            for q in (0.5, 0.9, 1.0)])
    return share, spans


def window_backward(args, tile):
    """The window design's gradients of one call (``csrc/
    deform_backward_window.cu``): (d x float32, d offset, d mask)."""
    from erd_tpu_torch.ops import cuda_build
    x, offset, mask, grad, k, stride, pad, dil, dg = args[:9]
    b, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    th, tw = tile
    window = ((th - 1) * stride + 2 * WINDOW_MARGIN + 2) * \
        ((tw - 1) * stride + 2 * WINDOW_MARGIN + 2)
    per = 4 + x.element_size()
    room = SHARED_BYTES_PER_SM // WINDOW_BLOCKS_PER_SM - 1024 - 64
    capacity = max(window, room // per)
    gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    goff = torch.empty(offset.shape, dtype=torch.float32, device=x.device)
    gmask = None if mask is None else torch.empty_like(mask)
    lib = cuda_build.load('deform_backward_window')
    fn = lib.erd_deform_backward_window
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), offset.data_ptr(),
             None if mask is None else mask.data_ptr(), grad.data_ptr(),
             gx.data_ptr(), goff.data_ptr(),
             None if gmask is None else gmask.data_ptr(), b, cin, h, w, ho,
             wo, k, stride, pad, dil, dg, int(x.dtype == torch.bfloat16), th,
             tw, WINDOW_MARGIN, capacity,
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, 'deform_backward_window')
    return gx, goff, gmask


def window_row(smoke, dcn, args, xshape):
    """The window design at one call: its largest error over max|plain|
    per gradient (a bound of 1e-5 checked) and its ms less the zeroing on
    each tile."""
    want = dcn.deform_im2col_backward_plain(*args)
    out = {}
    for tile in WINDOW_TILES:
        got = window_backward(args, tile)
        errs = {name: float((g - v).abs().max()) / float(v.abs().max())
                for name, g, v in zip(('x', 'offset', 'mask'), got, want)
                if v is not None}
        if max(errs.values()) > 1e-5:
            raise RuntimeError(f'window design, tile {tile}: {errs} over '
                               f'1e-5 of max|plain|')
        out[f'{tile[0]}x{tile[1]}'] = dict(
            err_over_max_plain=errs, ms=kernel_ms(
                smoke, lambda: window_backward(args, tile), xshape)[0])
    return out


def chunk_sweep(smoke, dcn, args, xshape):
    """The kernel's ms less the zeroing on map-gradient chunks of all the
    group's channels and of CHUNKS."""
    cpg = xshape[1] // args[8]
    out = {}
    for chunk in (cpg,) + tuple(c for c in CHUNKS if c < cpg):
        out[chunk] = kernel_ms(smoke, lambda: dcn._backward_launch(
            *args[:9], True, True, chunk), xshape)[0]
    return out


def probe_deform(smoke, report):
    dcn = importlib.import_module('erd_tpu_torch.ops.deform_conv')
    calls = captured_calls(
        smoke, dcn, 'deform_im2col_backward', smoke.dcn_train_net,
        smoke.DCN_CONFIGS,
        lambda a: (tuple(a[0].shape), a[5], a[2] is not None))
    headline = {('vfnet_r50_mdconv', (16, 256, 100, 168), 1, False): 'P3 head',
                ('gfl_r101_dcn', (16, 256, 50, 84), 1, False): 'R101 layer3'}
    rows, per_step = [], {}
    for kind, shapes in calls.items():
        for (xshape, stride, has_mask), (args, count) in shapes.items():
            ms, call = kernel_ms(
                smoke, lambda: dcn.deform_im2col_backward(*args), xshape)
            ho, wo = args[1].shape[2:]
            chunk = dcn.deform_backward_chunk(
                xshape[0], xshape[1], args[8], args[4], ho, wo,
                torch.cuda.get_device_properties(0).multi_processor_count)
            row = dict(config=kind, x=list(xshape), stride=stride,
                       mask=has_mask, calls=count, ms=ms, call_ms=call,
                       chunk=chunk,
                       by_chunk=chunk_sweep(smoke, dcn, args, xshape))
            per_step[kind] = per_step.get(kind, 0.0) + count * ms
            tag = headline.get((kind, xshape, stride, has_mask))
            if tag:
                row['tag'] = tag
                zero = (args[0], torch.zeros_like(args[1])) + args[2:]
                row['zero_offsets_ms'] = kernel_ms(
                    smoke, lambda: dcn.deform_im2col_backward(*zero),
                    xshape)[0]
                row['no_map_gradient_ms'] = smoke.events_ms(
                    torch, lambda: dcn.deform_im2col_backward(
                        *args[:9], need_x=False), 5)
                row['map_gradient_only_ms'] = kernel_ms(
                    smoke, lambda: dcn.deform_im2col_backward(
                        *args[:9], need_offset=False), xshape)[0]
                row['reach_share'], row['tile_spans'] = offset_reach(args)
                row['window_design'] = window_row(smoke, dcn, args, xshape)
            rows.append(row)
            print(f'probe 8b: {kind} x {xshape} stride {stride} mask '
                  f'{has_mask} (x{count} a step): {ms:.4f} ms (call '
                  f'{call:.4f}) on chunks of {chunk}; by chunk ' +
                  ', '.join(f'{c}: {t:.4f}' for c, t in
                            row['by_chunk'].items()) + ''.join(
                      f', {k} {row[k]:.4f}' for k in (
                          'zero_offsets_ms', 'no_map_gradient_ms',
                          'map_gradient_only_ms') if k in row) +
                  (f'; within m px {row["reach_share"]}; tile spans '
                   f'{row["tile_spans"]}; window design '
                   f'{row["window_design"]}' if 'tile_spans' in row else
                   ''), flush=True)
    for kind, total in per_step.items():
        print(f'probe 8b: {kind} one step\'s calls {total:.3f} ms', flush=True)
    report['deform_im2col_backward'] = dict(shapes=rows, per_step_ms=per_step)
    del calls
    torch.cuda.empty_cache()


def adds_per_row(shapes, locs):
    """Per level: the in-range corner adds of the call over its rows per
    (image, head)."""
    b, q, heads = locs.shape[:3]
    out = []
    for lvl, (h, w) in enumerate(shapes):
        loc = locs[:, :, :, lvl]
        x0 = torch.floor(loc[..., 0] * w - 0.5)
        y0 = torch.floor(loc[..., 1] * h - 0.5)
        n = 0
        for yy in (y0, y0 + 1):
            for xx in (x0, x0 + 1):
                n += int(((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).sum())
        out.append(n / (b * heads * h * w))
    return out


def probe_attention(smoke, report):
    msda = importlib.import_module('erd_tpu_torch.ops.ms_deform_attn')
    calls = captured_calls(
        smoke, msda, 'ms_deform_attn_backward', smoke.detr_train_net,
        smoke.DETR_CONFIGS, lambda a: a[2].shape[1])
    fn = msda.ms_deform_attn_backward
    out = dict(calls=[], per_step_ms={})
    encoder = None
    for kind, by_q in calls.items():
        for q, (args, count) in by_q.items():
            values, shapes = args[0], args[1]
            ms, call = kernel_ms(smoke, lambda: fn(*args), values.shape)
            part = 'encoder' if q == values.shape[1] else 'decoder'
            out['calls'].append(dict(config=kind, part=part, q=q,
                                     calls=count, ms=ms, call_ms=call))
            out['per_step_ms'][kind] = out['per_step_ms'].get(kind, 0.0) + \
                count * ms
            print(f'probe 9b: {kind} {part} Q={q} x {values.shape[0]} (x'
                  f'{count} a step): {ms:.4f} ms (call {call:.4f})',
                  flush=True)
            if part == 'encoder' and encoder is None:
                encoder = args
    values, shapes, locs, weights, grad = encoder
    out['encoder_adds_per_row'] = adds_per_row(shapes, locs)
    levels = []
    for lvl, (h, w) in enumerate(shapes):
        live = locs.clone()
        for other in range(len(shapes)):
            if other != lvl:
                live[:, :, :, other] = -2.0
        only = kernel_ms(smoke, lambda: fn(values, shapes, live, weights,
                                           grad), values.shape)[0]
        gen = torch.Generator(device=values.device).manual_seed(lvl)
        same = [(h, w)] * len(shapes)
        v4 = torch.randn(values.shape[0], len(shapes) * h * w,
                         *values.shape[2:], device=values.device,
                         generator=gen)
        all_on = kernel_ms(smoke, lambda: fn(v4, same, locs, weights, grad),
                           v4.shape)[0]
        levels.append(dict(level=lvl, hw=[h, w], only_this_level_ms=only,
                           all_on_this_size_ms=all_on,
                           adds_per_row=out['encoder_adds_per_row'][lvl]))
        print(f'probe 9b: encoder, level {lvl} ({h}x{w}, '
              f'{out["encoder_adds_per_row"][lvl]:.1f} adds a row): only its '
              f'samples live {only:.4f} ms; every sample on maps of its size '
              f'{all_on:.4f} ms', flush=True)
        del live, v4
    out['encoder_levels'] = levels
    report['ms_deform_attn_backward'] = out
    del calls, encoder
    torch.cuda.empty_cache()


def probe_attention_forward(smoke, report):
    """Kernel 9 at every call shape of one bs-16 DINO and Deformable DETR
    step, and at the bs-1 encoder call (the first image of the step's)."""
    head = importlib.import_module(
        'erd_tpu_torch.models.heads.deformable_detr_head')
    calls = captured_calls(
        smoke, head, 'ms_deform_attn', smoke.detr_train_net,
        smoke.DETR_CONFIGS, lambda a: (a[2].shape[1], a[3].dtype))
    fn = importlib.import_module('erd_tpu_torch.ops.ms_deform_attn'
                                 ).ms_deform_attn
    out = dict(calls=[], per_step_ms={})
    for kind, by_key in calls.items():
        for (q, wdtype), (args, count) in by_key.items():
            part = 'encoder' if q == args[0].shape[1] else 'decoder'
            ms = smoke.events_ms(torch, lambda: fn(*args), 10)
            graph = smoke.graph_ms(torch, lambda: fn(*args), 10)
            row = dict(config=kind, part=part, q=q, batch=args[0].shape[0],
                       weights=str(wdtype), calls=count, ms=ms,
                       graph_ms=graph)
            if part == 'encoder':
                one = tuple(a[:1] if torch.is_tensor(a) else a for a in args)
                row['batch1_ms'] = smoke.events_ms(torch, lambda: fn(*one),
                                                   20)
                row['batch1_graph_ms'] = smoke.graph_ms(
                    torch, lambda: fn(*one), 20)
            out['calls'].append(row)
            for key, t in (('per_step_ms', ms), ('per_step_graph_ms', graph)):
                out.setdefault(key, {})
                out[key][kind] = out[key].get(kind, 0.0) + count * t
            print(f'probe 9: {kind} {part} Q={q} x {args[0].shape[0]} '
                  f'weights {wdtype} (x{count} a step): {ms:.4f} ms, by '
                  f'graph replays {graph:.4f}' + (
                      f'; the first image alone {row["batch1_ms"]:.4f} ms, '
                      f'by graph replays {row["batch1_graph_ms"]:.4f}'
                      if 'batch1_ms' in row else ''), flush=True)
    for kind, total in out['per_step_ms'].items():
        print(f'probe 9: {kind} one step\'s calls {total:.3f} ms (by graph '
              f'replays {out["per_step_graph_ms"][kind]:.3f})', flush=True)
    report['ms_deform_attn'] = out
    del calls
    torch.cuda.empty_cache()


def mask_batch(smoke, kind):
    import numpy as np
    return next(iter(smoke.mask_train_loader(np, torch, kind, 1,
                                             61).epoch(0)))


def stores_for_adds_lib():
    """``csrc/roi_align.cu`` built with the backward kernel's float4 atomic
    adds replaced by plain stores (its sums wrong): a measurement's
    variant, compiled from an edited copy in the build directory."""
    from erd_tpu_torch.ops import cuda_build
    add = 'atomicAdd(dst, scale4(v, ws[k]));'
    src = (cuda_build.CSRC / 'roi_align.cu').read_text()
    if src.count(add) != 1:
        raise RuntimeError(f'roi_align.cu: {add!r} not found once')
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    copy = cuda_build.BUILD_DIR / 'roi_align_stores_for_adds.cu'
    copy.write_text(src.replace(add, '*dst = scale4(v, ws[k]);'))
    path = copy.with_suffix('.so')
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, '-o',
                    str(path), str(copy)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    lib.erd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.erd_cuda_error_string.restype = ctypes.c_char_p
    return lib


# 7b's device operations, by the profiler's names
ROI_BACKWARD_OPS = {'zero': 'Memset', 'kernel': 'roi_align_backward_kernel',
                    'round': 'roi_align_backward_finish'}


def device_ops_ms(fn, names, n=5):
    """{key: device ms a call} of the operations whose profiler name holds
    ``names[key]`` (None where the profiler shows none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for key, name in names.items():
        us = sum(getattr(ev, 'device_time_total', None) or
                 getattr(ev, 'cuda_time_total', 0.0)
                 for ev in prof.key_averages() if name in ev.key)
        out[key] = us / n / 1e3 if us > 0 else None
    return out


def nonzero_tiles(grads):
    """The share of the maps' 32-pixel tiles (of each flat H * W, over
    the batch) where some channel's gradient is nonzero."""
    hit = total = 0
    for g in grads:
        b, _, h, w = g.shape
        flat = torch.nn.functional.pad((g != 0).any(1).reshape(b, h * w),
                                       (0, -(-h * w // 32) * 32 - h * w))
        tiles = flat.reshape(b, -1, 32).any(2)
        hit += int(tiles.sum())
        total += tiles.numel()
    return hit / total


def fmt(v):
    return 'not measured' if v is None else f'{v:.4f}'


def probe_roi_backward(smoke, report):
    """Kernel 7b at every call of one bs-16 step of Faster R-CNN (the
    box call), Mask R-CNN and PointRend (box and out-14 mask calls): the
    call, its memset, kernel and rounding pass, the share of tiles with a
    gradient, and the kernel with stores for its adds."""
    from erd_tpu_torch.ops import cuda_build
    ra = importlib.import_module('erd_tpu_torch.ops.roi_align')
    calls = {}
    for kind in ('frcnn',) + tuple(smoke.MASK_CONFIGS):
        if kind == 'frcnn':
            got = captured_calls(
                smoke, ra, 'roi_align_backward', smoke.train_net, (kind,),
                lambda a: a[0].shape[3])
        else:
            got = captured_calls(
                smoke, ra, 'roi_align_backward', smoke.mask_train_net,
                (kind,), lambda a: a[0].shape[3],
                lambda k: mask_batch(smoke, k))
        calls.update(got)
    path_lib = cuda_build.load('roi_align')
    stores_lib = stores_for_adds_lib()
    out = dict(calls=[], per_step_ms={})
    fn = ra.roi_align_backward
    for kind, by_out in calls.items():
        for out_size, (args, count) in sorted(by_out.items()):
            grad = args[0]
            live = int((grad.flatten(2).abs().amax(2) > 0).sum())  # RoIs
            call = smoke.events_ms(torch, lambda: fn(*args), 5)
            ms = device_ops_ms(lambda: fn(*args), ROI_BACKWARD_OPS)
            reached = nonzero_tiles(fn(*args[:5], torch.float32,
                                       *args[6:]))
            cuda_build._LIBS['roi_align'] = stores_lib
            try:
                stores = device_ops_ms(lambda: fn(*args), dict(
                    kernel=ROI_BACKWARD_OPS['kernel']))['kernel']
            finally:
                cuda_build._LIBS['roi_align'] = path_lib
            row = dict(config=kind, out=out_size, grad=list(grad.shape),
                       maps=str(args[5]), live_rois=live, calls=count,
                       call_ms=call, kernel_ms=ms['kernel'],
                       zero_ms=ms['zero'], round_ms=ms['round'],
                       nonzero_tiles=reached, stores_for_adds_ms=stores)
            out['calls'].append(row)
            out['per_step_ms'][kind] = out['per_step_ms'].get(kind, 0.0) + \
                count * call
            print(f'probe 7b: {kind} out {out_size} grad '
                  f'{tuple(grad.shape)} maps {args[5]} ({live} RoIs with a '
                  f'gradient; x{count} a step): call {call:.4f} ms; device '
                  f'(profiler): zeroing {fmt(ms["zero"])}, kernel '
                  f'{fmt(ms["kernel"])}, rounding {fmt(ms["round"])}; '
                  f'{reached:.1%} of the tiles with a gradient; the kernel '
                  f'with stores for its adds {fmt(stores)}', flush=True)
    for kind, total in out['per_step_ms'].items():
        print(f'probe 7b: {kind} one step\'s calls {total:.3f} ms', flush=True)
    report['roi_align_backward'] = out
    del calls
    torch.cuda.empty_cache()


def probe_other_backwards(smoke, report):
    """Call time (events) of 10b at the 3 calls of one FPN-CARAFE step and
    of 12a-b in the 4 directions of one CornerNet step (bs 6)."""
    cb = importlib.import_module('erd_tpu_torch.ops.carafe')
    calls = captured_calls(smoke, cb, 'carafe_backward', smoke.train_net,
                           ('carafe',), lambda a: tuple(a[0].shape))
    rows = []
    for shape, (args, count) in sorted(calls['carafe'].items()):
        ms = smoke.events_ms(torch, lambda: cb.carafe_backward(*args), 5)
        rows.append(dict(x=list(shape), calls=count, call_ms=ms))
        print(f'probe 10b: carafe x {shape} (x{count} a step): {ms:.4f} ms',
              flush=True)
    report['carafe_backward'] = dict(calls=rows, per_step_ms=sum(
        r['calls'] * r['call_ms'] for r in rows))
    del calls
    en = importlib.import_module('erd_tpu_torch.ops.extra_nms')
    calls = captured_calls(
        smoke, en, 'corner_pool_backward', smoke.mask_train_net,
        ('cornernet',), lambda a: a[2], lambda k: mask_batch(smoke, k))
    rows = []
    for direction, (args, count) in calls['cornernet'].items():
        ms = smoke.events_ms(torch, lambda: en.corner_pool_backward(*args),
                             5)
        rows.append(dict(direction=direction, x=list(args[0].shape),
                         calls=count, call_ms=ms))
        print(f'probe 12a-b: {direction} x {tuple(args[0].shape)} (x{count} '
              f'a step): {ms:.4f} ms', flush=True)
    report['corner_pool_backward'] = dict(calls=rows, per_step_ms=sum(
        r['calls'] * r['call_ms'] for r in rows))
    del calls
    torch.cuda.empty_cache()


# the probe's parts, by the kernel rows of PERF.md
PARTS = {'8b': probe_deform, '9b': probe_attention,
         '9': probe_attention_forward, '7b': probe_roi_backward,
         'others': probe_other_backwards}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parts = list(PARTS)
    if '--only' in argv:
        parts = argv[argv.index('--only') + 1].split(',')
        unknown = [p for p in parts if p not in PARTS]
        if unknown:
            print(f'atomic_backward_probe: no part {unknown}; the parts are '
                  f'{list(PARTS)}', file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print('atomic_backward_probe: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smoke = importlib.import_module('chip_smoke')
    card = smoke.card_line()
    print(card, flush=True)
    report = {'card': card}
    for part in parts:
        PARTS[part](smoke, report)
    print(json.dumps(report))
    return 0


if __name__ == '__main__':
    sys.exit(main())
