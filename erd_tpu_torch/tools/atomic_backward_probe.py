"""Where the redesigned kernels and the atomic backward kernels spend
their time, on one CUDA GPU: the deformable im2col backward
(``erd_deform_im2col_backward``, kernel 8b), the multi-scale deformable
attention backward and forward (kernels 9b and 9), the RoIAlign backward
(7b) and forward (row 7), the NMS keep kernel (row 1, with set-NMS, 11b),
the CARAFE backward (10b) and forward (row 10), the point-sample backward
(13a-b), the fused GFL loss (row 3), ATSS (row 6), the fused ERD
distillation (row 4), the ERS selection (row 5), the soft-NMS scan (11a),
the CornerNet corner targets (row 15), the point-sample forward (13a),
the mask targets (row 14), and the call times of the corner-pool backward
(12a-b). Run from the repository root:

    python3 -m erd_tpu_torch.tools.atomic_backward_probe [--only 11a,15]

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
5. 1, the NMS keep kernel (``csrc/nms.cu``) at the calls that
   ``chip_smoke.py`` makes: the RPN's call of one bs-16 Faster R-CNN step
   (K = 8819, IoU 0.7), ERD's two distillation calls (bs 16, K = 1024 and
   4481, IoU 0.005, on ``chip_smoke.py``'s train case), the GFL serving
   call (``chip_smoke.py``'s K = 2000 case at bs 1), the RPN and R-CNN
   calls of one Faster R-CNN request (K = 4819 and 2000) and the set-NMS
   call of one CrowdDet request (K = 2000). At each: the call by CUDA-graph
   replays and by events, the bitmask launch and the reduce launch apart
   (graph replays; where the library has one entry point for both, the
   bitmask launch alone comes from a copy of ``csrc/nms.cu`` edited in
   the build directory so that it skips the reduce, and the reduce is the
   difference), the share of upper-triangle pairs whose overlap is zero,
   the share of the 64-bit mask words right of the diagonal that are
   nonzero, the valid and the kept boxes, the bound (as ``chip_smoke.py``
   counts it), and the keep mask against the plain version and its time
   (events).
6. 7, the RoIAlign forward (``erd_roi_align``), at the box call (out 7)
   of one Faster R-CNN, Mask R-CNN and PointRend step, the out-14 mask
   call of the last two, and the two serving calls ``PERF.md`` quotes
   (1000 proposals of a Faster R-CNN request, 100 detections of a Mask
   R-CNN request at out 14, with ``chip_smoke.py``'s edge boxes): the call
   by graph replays and events, the plain version's time, the bytes bound
   over the batch, the share of samples off their map, the RoIs per level
   and their extent in pixels of their level, the elements where kernel
   and plain differ (beside the 1e-6 * max|feat| gate), and by graph
   replays the kernel without its map reads, without its store and
   without its shuffles (``ROI_FORWARD_PARTS``, edited copies of
   ``csrc/roi_align.cu``, on no path).
7. 10b, the CARAFE backward, at the 3 calls of one FPN-CARAFE step: the
   call by graph replays and events, each launch alone and the parts of
   ``CARAFE_BACKWARD_PARTS`` (edited copies of ``csrc/carafe.cu``: the
   parent design's float32 weight scratch taken out, the redesign's sums,
   softmax, copies or gather weights taken out), the scratch's bytes,
   the bound, the error against plain.
8. 10, the CARAFE forward, at the 3 calls of the same step and the 3 calls
   of one 800x1333 request: the call by graph replays and events, the
   plain version's time, the bound (``chip_smoke.carafe_cost``), the
   elements where kernel and plain differ and the largest bf16 ulp
   distance, and by graph replays the kernel with its tap loads, its
   store or its softmax replaced (``CARAFE_FORWARD_PARTS``, edited copies
   of ``csrc/carafe.cu``, on no path).
9. 13a-b, the point-sample backward, at the 2 calls of one PointRend step
   (the bf16 P2 call, the float32 coarse call): the call by graph replays
   and events, its device operations apart by the profiler
   (``POINT_BACKWARD_OPS``), the strides of the maps, the gradient and the
   result, the points an image, the share of corners off the map, the
   corner adds a touched pixel, the share of 8 x 32-pixel tiles a corner
   reaches (``corner_stats``), whether two calls are equal, and the
   ``POINT_BACKWARD_PARTS`` variants (edited copies of
   ``csrc/point_sample.cu``, on no path).
10. others: the call time of the corner-pool backward (12a-b) in the 4
   directions of one CornerNet step: by events and graph replays on the
   step's own tensors (their strides printed), and on NCHW copies of them
   made before the timing (no copy in the call), and the copies alone;
   where the kernel reads both layouts in place, also by graph replays of
   the kernel with its tree skipped and with its global loads and stores
   replaced (``POOL_BACKWARD_PARTS``, built from edited copies of
   ``csrc/corner_pool.cu`` in the build directory, on no path).
11. 3 and 6, the fused GFL loss and ATSS, at an ERD, a GFL R101-DCN and a
   VFNet step's calls (``loss_calls``; ``probe_gfl_loss``,
   ``probe_atss``).
12. 4, the fused ERD distillation, at one ERD step's call
   (``distill_calls``): the rows each mask selects, forward and forward +
   backward by graph replays and events, a wide gradient's zero-fill and
   slice copy, the kernels by the profiler, registers and spills, plain,
   both bounds, the errors, and the ``DISTILL_TRITON_PARTS`` /
   ``DISTILL_PARTS`` variants (``probe_distill``).
13. 5, the ERS selection, at the same step's call: candidates and ties at
   the cap-th criterion, every launch and memset by the profiler, plain,
   the bound, the list and masks against plain, and the ``ERS_PARTS``
   variants (``probe_ers``).

14. 11a, the soft-NMS scan, at the calls of ``soft_nms_calls`` (Faster
   R-CNN soft's K = 2000 linear call of one 800x1333 request, CornerNet's
   K = 10000 gaussian call of one 768x1024 request, ``chip_smoke.py``'s
   large-K case): graph replays, events, the profiler, the live
   candidates, the step from which nothing is live, the candidates a
   step's winner overlaps, the plan, plain, the bound, the selections
   against plain; the redesign with each cluster size forced and the
   ``SOFT_NMS_PARTS`` variants (blocks of 1024, 256 and 128 threads); and
   the latency floor (``probe_soft_nms_floor``, also part 11a-floor on
   its own, model-free): the steps emptied, from edited copies
   (``chip_smoke.SOFT_NMS_FLOOR_EDITS``, with each variant and each of
   ``SOFT_NMS_FLOOR_PARTS``), on no path.
15. 15, the corner targets at one bs-6 CornerNet step's call: graph
   replays, the eager call by events, the device operations by the
   profiler (the kernel, the zero-fills, the rest), plain, the bound, the
   outputs against plain.

16. 13a, the point-sample forward, at the four calls of one bs-16
   PointRend step (uncertainty, coarse, fine, targets) and the two call
   shapes of one request: graph replays, events (the eager call), plain,
   F.grid_sample on the widened float32 map, the bytes bound, the maps'
   strides, the layout (``point_sample_plan``) and its active lanes a
   warp, the output against plain (torch.equal); every other layout that
   takes the call, forced, and the ``POINT_FORWARD_PARTS`` variants; at
   the serving calls the host's time a call by cProfile
   (``host_profile``).
17. 14, the mask targets at one bs-16 Mask R-CNN step's call (28 x 28)
   and one PointRend step's (14 x 14): graph replays, events, plain, the
   F.grid_sample formulation, the bound, the targets against plain
   (torch.equal), the ``MASK_TARGET_PARTS`` variants, the host's time a
   call.
18. 2, the GFL integral decode (``probe_decode``), at one 800x1333
   request of GFL R50 and of GFL R101-DCN (5000 candidate rows of the
   five level maps) and ERD's two training calls (16 x 1024 and 16 x 4481
   rows of the flat teacher map): graph replays, events (the eager call),
   plain, the bound, the error against the gate; at the serving calls
   the maps' dtypes and strides, the parent's feeding launches (five
   ``.float()`` and ``flatten_levels``) timed apart and with the call,
   the post-processing's launches, the host's time a call.
19. 12b, the matrix decay (``probe_decay``), at one SOLOv2 request's call
   (N = 500, its live slots): the four elementwise launches that make the
   mask IoU, ``matrix_decay`` on it, the two together, and the fused
   ``mask_matrix_decay`` on inter and area where the tree has it (graph,
   events, launches, error against plain, host time); the box form
   ``matrix_nms`` at K = 2000.

A variant whose edits do not fit the source (another design's) is "not
measured". ``--only 9,7b`` runs the named parts alone, in that order (the
parts: 8b, 9b, 9, 7b, 1, 7, 10b, 10, 13a-b, 3, 6, 4, 5, 11a, 11a-floor,
15, 13a, 14, 2, 12b, others).

Prints a line per measurement and, last, one JSON object of them all.
"""
from __future__ import annotations

import ctypes
import functools
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


def edited_lib(name, variant, edits):
    """``csrc/<name>.cu`` with each text of ``edits`` replaced (each must
    be found), built in the build directory as ``<name>_<variant>``: a
    measurement's variant, on no path."""
    from erd_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / f'{name}.cu').read_text()
    for old, new in edits.items():
        if old not in src:
            raise RuntimeError(f'{name}.cu: {old!r} not found')
        src = src.replace(old, new)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    copy = cuda_build.BUILD_DIR / f'{name}_{variant}.cu'
    copy.write_text(src)
    path = copy.with_suffix('.so')
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, '-o',
                    str(path), str(copy)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    lib.erd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.erd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def stores_for_adds_lib():
    """``csrc/roi_align.cu`` built with the backward kernel's float4 atomic
    adds replaced by plain stores (its sums wrong): a measurement's
    variant, on no path."""
    return edited_lib('roi_align', 'stores_for_adds', {
        'atomicAdd(dst, scale4(v, ws[k]));': '*dst = scale4(v, ws[k]);'})


# 7b's device operations, by the profiler's names
ROI_BACKWARD_OPS = {'zero': 'Memset', 'kernel': 'roi_align_backward_kernel',
                    'round': 'roi_align_backward_finish'}


def device_ops_ms(fn, names, n=5):
    """{key: device ms a call} of the operations whose profiler name holds
    ``names[key]``, a text or a tuple of texts (None where the profiler
    shows none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for key, name in names.items():
        texts = (name,) if isinstance(name, str) else name
        us = sum(getattr(ev, 'device_time_total', None) or
                 getattr(ev, 'cuda_time_total', 0.0)
                 for ev in prof.key_averages()
                 if any(t in ev.key for t in texts))
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


def nms_stats(sboxes, svalid, thr, sgroup=None, rows=512):
    """Counts of one sorted NMS call, image by image in row chunks: the
    upper-triangle pairs (j > i) and how many have a zero overlap (iw or
    ih 0), the mask words right of the diagonal (row i, word w >= i // 64)
    and how many are nonzero (the plain version's suppression bits:
    iou > thr, row i valid, and for set-NMS the groups apart), and the
    valid boxes."""
    b, k = sboxes.shape[:2]
    words = -(-k // 64)
    pairs = zero = nonzero = 0
    for img in range(b):
        bx, valid = sboxes[img], svalid[img]
        x1, y1, x2, y2 = bx.unbind(-1)
        area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
        col = torch.arange(k, device=bx.device)
        for a in range(0, k, rows):
            r = slice(a, min(a + rows, k))
            later = col[None, :] > col[r, None]
            iw = (torch.minimum(x2[r, None], x2[None]) -
                  torch.maximum(x1[r, None], x1[None])).clamp(min=0)
            ih = (torch.minimum(y2[r, None], y2[None]) -
                  torch.maximum(y1[r, None], y1[None])).clamp(min=0)
            ov = iw * ih
            iou = ov / (area[r, None] + area[None] - ov).clamp(min=1e-6)
            sup = (iou > thr) & later & valid[r, None]
            if sgroup is not None:
                sup &= sgroup[img][r, None] != sgroup[img][None]
            pairs += int(later.sum())
            zero += int(((iw == 0) | (ih == 0))[later].sum())
            hit = torch.nn.functional.pad(sup, (0, words * 64 - k)).reshape(
                -1, words, 64).any(-1)
            right = torch.arange(words, device=bx.device)[None] >= \
                (col[r, None] // 64)
            nonzero += int(hit[right].sum())
    total_words = b * sum(words - i // 64 for i in range(k))
    return dict(pairs=pairs, zero_overlap_share=zero / max(pairs, 1),
                mask_words=total_words,
                nonzero_word_share=nonzero / max(total_words, 1),
                valid=int(svalid.sum()))


def nms_calls(smoke):
    """[(name, 'nms' or 'set', args)]: the sorted-NMS calls of part 1, as
    ``chip_smoke.py`` makes them."""
    import numpy as np

    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.models.detectors.gfl_erd import _kept_dense
    from erd_tpu_torch.models.heads.gfl_head import AnchorContext
    from erd_tpu_torch.ops.ers_select import ers_select
    nms = importlib.import_module('erd_tpu_torch.ops.nms')
    out = []
    got = smoke.train_step_calls(np, torch, 'frcnn', ('nms_sorted_keep',))
    out.append(('frcnn_train_rpn', 'nms', got['nms_sorted_keep'][0]))
    del got
    rs = np.random.RandomState(5)
    ctx = AnchorContext.build(smoke.TRAIN_CANVAS)
    smoke.train_case(np, torch, rs, ctx, 2)
    case = smoke.train_case(np, torch, rs, ctx, smoke.TRAIN_BATCH)
    n = ctx.num_anchors
    centers, _ = ctx.device_tensors(smoke.DEV)
    unit = torch.ones(n, device=smoke.DEV)
    _, ri, rm, _ = ers_select(case['t_cls'], case['t_reg'], n // 5 + 1)
    for k in (1024, n // 5 + 1):
        seen = []
        restore = smoke.capture(nms, 'nms_sorted_keep', seen)
        try:
            _kept_dense(centers, unit, case['t_cls'], case['t_reg'],
                        ri[:, :k].contiguous(), rm[:, :k].contiguous(),
                        0.005, 16)
        finally:
            restore()
        out.append((f'erd_train_k{k}', 'nms', seen[0]))
    del case
    rs = np.random.RandomState(0)
    smoke.nms_case(np, torch, rs, 2, 2000)
    smoke.nms_case(np, torch, rs, 2, 4481)
    out.append(('gfl_serve', 'nms',
                tuple(smoke.nms_case(np, torch, rs, 1, 2000)) + (0.6,)))
    det, net, _ = init_detector(smoke.FRCNN_CONFIGS['nms'], device=smoke.DEV)
    batch, _ = smoke.request_batch(np, torch, smoke.REQUESTS[-1])
    smoke.arrange_fc_cls(torch, det, net, batch)
    seen = []
    restore = smoke.capture(nms, 'nms_sorted_keep', seen)
    try:
        det.predict(net, batch)
    finally:
        restore()
    out += [('frcnn_serve_rpn', 'nms', seen[0]),
            ('frcnn_serve_rcnn', 'nms', seen[1])]
    det, net = smoke.carafe_net(np, torch, 'crowddet')
    seen = []
    restore = smoke.capture(nms, 'set_nms_sorted_keep', seen)
    try:
        det.predict(net, batch)
    finally:
        restore()
    out.append(('crowddet_serve_set_nms', 'set', seen[0]))
    del det, net
    torch.cuda.empty_cache()
    return out


def mask_only_lib():
    """``csrc/nms.cu`` built so that its one entry point launches the
    bitmask kernel and skips the reduce: a measurement's variant for a
    library with one entry point for both (the parent's), on no path."""
    return edited_lib('nms', 'mask_only', {
        'nms_reduce_kernel<<<': 'if (false) nms_reduce_kernel<<<'})


def nms_parts(smoke, kind, args):
    """(bitmask ms, reduce ms, how): each launch by graph replays on
    buffers made once; the library's two entry points where it has them,
    else the bitmask alone from ``mask_only_lib`` and the reduce as the
    call less it."""
    from erd_tpu_torch.ops import cuda_build
    sboxes, svalid = args[0], args[1]
    sgroup, order, thr = (args[2], args[3], args[4]) if kind == 'set' else \
        (None, args[2], args[3])
    b, k = sboxes.shape[:2]
    words = -(-k // 64)
    dev = sboxes.device
    mask = torch.empty((b, k, words), dtype=torch.int64, device=dev)
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    group = None if sgroup is None else sgroup.data_ptr()
    lib = cuda_build.load('nms')
    vp, ci = ctypes.c_void_p, ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream
    if hasattr(lib, 'erd_nms_reduce'):
        nz = torch.empty((b, words, words), dtype=torch.int64, device=dev)
        lib.erd_nms_mask.argtypes = [vp] * 5 + [ci, ci, ctypes.c_float, vp]
        lib.erd_nms_reduce.argtypes = [vp] * 5 + [ci, ci, vp]

        def mask_call():
            lib.erd_nms_mask(sboxes.data_ptr(), svalid.data_ptr(), group,
                             mask.data_ptr(), nz.data_ptr(), b, k,
                             float(thr), stream())

        def reduce_call():
            lib.erd_nms_reduce(mask.data_ptr(), nz.data_ptr(),
                               svalid.data_ptr(), order.data_ptr(),
                               keep.data_ptr(), b, k, stream())
        mask_call()
        return (smoke.graph_ms(torch, mask_call),
                smoke.graph_ms(torch, reduce_call), 'entry points')
    only = mask_only_lib()
    only.erd_nms_keep.argtypes = [vp] * 6 + [ci, ci, ctypes.c_float, vp]

    def mask_call():
        only.erd_nms_keep(sboxes.data_ptr(), svalid.data_ptr(), group,
                          order.data_ptr(), mask.data_ptr(), keep.data_ptr(),
                          b, k, float(thr), stream())
    return smoke.graph_ms(torch, mask_call), None, 'mask-only copy'


def probe_nms(smoke, report):
    """Row 1 (and 11b) at every call of ``nms_calls``: the call, its two
    launches, the counts of ``nms_stats``, the keep mask against plain."""
    nms = importlib.import_module('erd_tpu_torch.ops.nms')
    rows = []
    for name, kind, args in nms_calls(smoke):
        fn = nms.set_nms_sorted_keep if kind == 'set' else \
            nms.nms_sorted_keep
        plain = nms.set_nms_sorted_keep_plain if kind == 'set' else \
            nms.nms_sorted_keep_plain
        keep = fn(*args)
        mism = int((keep != plain(*args)).sum())
        graph = smoke.graph_ms(torch, lambda: fn(*args))
        events = smoke.events_ms(torch, lambda: fn(*args), 10)
        plain_ms = smoke.events_ms(torch, lambda: plain(*args), 2)
        mask_ms, reduce_ms, how = nms_parts(smoke, kind, args)
        if reduce_ms is None:
            reduce_ms = graph - mask_ms
        stats = nms_stats(args[0], args[1], args[-1],
                          args[2] if kind == 'set' else None)
        b, k = args[0].shape[:2]
        # the bound as chip_smoke.py counts it: 14 operations an IoU of a
        # valid row with each later box (15 with the group test), 3 a
        # box's area; each box, flag, index (and group) read once, each
        # keep flag written once
        rows_valid = torch.nonzero(args[1])[:, 1].double()
        ops = (15.0 if kind == 'set' else 14.0) * float(
            (k - 1 - rows_valid).sum()) + 3.0 * b * k
        bound, bound_by = smoke.bound_of(
            b * k * (16 + 1 + 8 + (8 if kind == 'set' else 0)) + b * k, ops)
        row = dict(call=name, kind=kind, batch=b, k=k, iou=float(args[-1]),
                   call_graph_ms=graph, call_events_ms=events,
                   mask_ms=mask_ms, reduce_ms=reduce_ms, split_by=how,
                   bound_ms=bound, bound_by=bound_by, plain_ms=plain_ms,
                   kept=int(keep.sum()), mismatches=mism, **stats)
        rows.append(row)
        print(f'probe 1: {name} ({kind}) B={b} K={k} iou={row["iou"]}: '
              f'call {graph:.4f} ms (graph), {events:.4f} (events); '
              f'bitmask {mask_ms:.4f}, reduce {reduce_ms:.4f} ({how}); '
              f'bound {bound:.5f} ({bound_by}); plain {plain_ms:.3f}; '
              f'valid {stats["valid"]}, kept {row["kept"]}, '
              f'mismatches={mism}; zero-overlap pairs '
              f'{stats["zero_overlap_share"]:.4f} of {stats["pairs"]}, '
              f'nonzero mask words {stats["nonzero_word_share"]:.5f} of '
              f'{stats["mask_words"]}', flush=True)
    report['nms_keep'] = rows
    torch.cuda.empty_cache()


# edits of csrc/corner_pool.cu for part others: the backward kernel with
# its tree skipped (staging, the leaves' shared-memory reads and writes,
# the stores), and with its global loads and stores replaced (the tree and
# shared memory alone)
POOL_BACKWARD_PARTS = {
    'no_tree': {'ray_backward<S>(l, n, lane);': ''},
    'no_global': {
        'widen(base[p * s.p])': 'static_cast<float>((p * 7) & 15)',
        'narrow(src[tile_at(p, r)], base + p * s.p);':
            'if (src[tile_at(p, r)] == 12345.f) narrow(0.f, base);'},
}


def probe_other_backwards(smoke, report):
    """Call time of 12a-b in the 4 directions of one CornerNet step (bs
    6)."""
    from erd_tpu_torch.ops import cuda_build
    en = importlib.import_module('erd_tpu_torch.ops.extra_nms')
    calls = captured_calls(
        smoke, en, 'corner_pool_backward', smoke.mask_train_net,
        ('cornernet',), lambda a: a[2], lambda k: mask_batch(smoke, k))
    rows = []
    for direction, (args, count) in calls['cornernet'].items():
        x, g = args[0], args[1]
        xc, gc = x.contiguous(), g.contiguous()
        ms = smoke.events_ms(torch, lambda: en.corner_pool_backward(*args),
                             5)
        graph = smoke.graph_ms(torch, lambda: en.corner_pool_backward(*args),
                               10)
        nchw = smoke.graph_ms(torch, lambda: en.corner_pool_backward(
            xc, gc, direction), 10)
        copies = smoke.graph_ms(torch, lambda: (x.contiguous(),
                                                g.contiguous()), 10)
        out = en.corner_pool_backward(*args)
        parts = {}
        if hasattr(en, 'MAX_BACKWARD_RAY'):  # the design with the parts
            path_lib = cuda_build.load('corner_pool')
            for variant, edits in POOL_BACKWARD_PARTS.items():
                cuda_build._LIBS['corner_pool'] = edited_lib(
                    'corner_pool', variant, edits)
                try:
                    parts[variant] = smoke.graph_ms(
                        torch, lambda: en.corner_pool_backward(*args), 10)
                finally:
                    cuda_build._LIBS['corner_pool'] = path_lib
        rows.append(dict(direction=direction, x=list(x.shape),
                         x_stride=list(x.stride()), g_stride=list(g.stride()),
                         out_stride=list(out.stride()), calls=count,
                         call_ms=ms, call_graph_ms=graph, nchw_graph_ms=nchw,
                         copies_graph_ms=copies, **parts))
        print(f'probe 12a-b: {direction} x {tuple(x.shape)} (x{count} a '
              f'step), strides x {x.stride()} grad {g.stride()} out '
              f'{out.stride()}: call {ms:.4f} ms (events), {graph:.4f} '
              f'(graph); on NCHW copies made before {nchw:.4f} (graph); '
              f'the two copies alone {copies:.4f} (graph)' + ''.join(
                  f'; {k} {v:.4f}' for k, v in parts.items()), flush=True)
    report['corner_pool_backward'] = dict(calls=rows, per_step_ms=sum(
        r['calls'] * r['call_ms'] for r in rows))
    del calls
    torch.cuda.empty_cache()


def fitting_edits(name, alternatives):
    """The first edit set of ``alternatives`` whose texts are all in
    ``package_source(name)`` (one set per design the probe has measured),
    or None where none fits or the source is not there."""
    path = package_source(name)
    if not path.exists():
        return None
    src = path.read_text()
    return next((edits for edits in alternatives
                 if all(old in src for old in edits)), None)


def variant_lib(name, variant, alternatives):
    """``edited_lib`` with ``fitting_edits``, or None where none fits."""
    edits = fitting_edits(name, alternatives)
    return None if edits is None else edited_lib(name, variant, edits)


def with_lib(name, lib, fn):
    """``fn()`` with ``cuda_build.load(name)`` returning ``lib``."""
    from erd_tpu_torch.ops import cuda_build
    path_lib = cuda_build.load(name)
    cuda_build._LIBS[name] = lib
    try:
        return fn()
    finally:
        cuda_build._LIBS[name] = path_lib


# edits of csrc/roi_align.cu for part 7: the forward kernel with its map
# reads replaced by constants (geometry, tables and the store left), and
# with its store replaced by a test that keeps the sums live (the reads
# and sums left); one edit set for each design measured
ROI_FORWARD_PARTS = {
    'no_gathers': (
        {'widen(f, r0 + x0)': '1.f', 'widen(f, r0 + x1i)': '2.f',
         'widen(f, r1 + x0)': '3.f', 'widen(f, r1 + x1i)': '4.f'},
        {'b0[k] = x0 >= 0 ? widen(f[k], y + x0) : 0.f;': 'b0[k] = 1.f;',
         'b1[k] = x0 >= 0 ? widen(f[k], y + x1) : 0.f;': 'b1[k] = 2.f;'}),
    'no_store': (
        {'out[t] = __fdiv_rn(acc, static_cast<float>(s * s));':
         'if (acc == 12345.f) out[t] = 0.f;'},
        {'if (live[k] && ix == 0)\n':
         'if (live[k] && ix == 0 && acc == 12345.f)\n'}),
    'no_shuffles': (
        {'acc = __fadd_rn(acc, __shfl_down_sync(kFull, v[iy][k], dx));':
         'acc = __fadd_rn(acc, v[iy][k]);'},),
}


def roi_extent(rois, levels, strides=(4, 8, 16, 32)):
    """Quantiles (10, 50, 90 %) of the RoIs' height and width in pixels
    of their own level."""
    scale = 1.0 / torch.tensor(strides, device=rois.device)[levels.long()]
    hw = (rois[..., 2:] - rois[..., :2]).flip(-1) * scale[..., None]
    q = torch.tensor([0.1, 0.5, 0.9], device=rois.device)
    return {name: [round(float(v), 2)
                   for v in hw[..., k].flatten().quantile(q)]
            for k, name in enumerate(('height', 'width'))}


def with_edge_rois(smoke, args, batch):
    """A serving call's arguments with the last 10 RoI slots replaced by
    ``chip_smoke.serve_edge_rois`` and the levels mapped anew, as
    ``chip_smoke.py`` checks that call."""
    from erd_tpu_torch.ops import map_roi_levels
    rois = args[1].clone()
    h, w = batch['images'].shape[1:3]
    rois[0, -10:] = smoke.serve_edge_rois(torch, w, h)
    return (args[0], rois, map_roi_levels(rois, 4).contiguous()) + \
        tuple(args[3:])


def roi_forward_calls(smoke):
    """[(name, args)]: part 7's RoIAlign forward calls: the out-7 box call
    of one bs-16 800x1344 step of Faster R-CNN, Mask R-CNN and PointRend,
    the out-14 mask call of the last two, and the two serving calls that
    ``PERF.md`` quotes (one 800x1333 Faster R-CNN request's 1000 proposals,
    one Mask R-CNN request's 100 detections at out 14; each with the 10
    edge boxes of ``chip_smoke.py``)."""
    import numpy as np

    from erd_tpu_torch.apis import init_detector
    ra = importlib.import_module('erd_tpu_torch.ops.roi_align')

    def detached(args):
        return tuple([f.detach() for f in a] if isinstance(a, list) else
                     a.detach() if torch.is_tensor(a) else a for a in args)
    out = []
    got = smoke.train_step_calls(np, torch, 'frcnn', ('roi_align',))
    out.append(('frcnn train box', detached(got['roi_align'][0])))
    for kind in smoke.MASK_CONFIGS:
        got = smoke.mask_train_step_calls(np, torch, kind, ('roi_align',))
        for args in sorted(got['roi_align'], key=lambda a: a[4]):
            part = 'box' if args[4] == 7 else 'mask'
            out.append((f'{kind} train {part}', detached(args)))
    del got
    torch.cuda.empty_cache()
    for kind, call in (('frcnn', 0), ('mask_rcnn', 1)):
        if kind == 'frcnn':
            det, net, _ = init_detector(smoke.FRCNN_CONFIGS['nms'],
                                        device=smoke.DEV)
            batch, _ = smoke.request_batch(np, torch, smoke.REQUESTS[-1])
            smoke.arrange_fc_cls(torch, det, net, batch)
        else:
            det, net, batch = smoke.mask_net(np, torch, kind)
        seen = []
        restore = smoke.capture(ra, 'roi_align', seen)
        try:
            det.predict(net, batch)
        finally:
            restore()
        out.append((f'{kind} serve out {seen[call][4]}',
                    with_edge_rois(smoke, detached(seen[call]), batch)))
        del det, net, seen
        torch.cuda.empty_cache()
    return out


def probe_roi_forward(smoke, report):
    """Row 7 at every call of ``roi_forward_calls``: the call by graph
    replays and events, the plain version's time, the bytes bound over
    the batch, the share of samples off their map, the RoIs per level, the
    elements where kernel and plain differ (beside the 1e-6 * max|feat|
    gate), and the ``ROI_FORWARD_PARTS`` variants by graph replays."""
    ra = importlib.import_module('erd_tpu_torch.ops.roi_align')
    variants = {v: variant_lib('roi_align', f'forward_{v}', alts)
                for v, alts in ROI_FORWARD_PARTS.items()}
    rows = []
    for name, args in roi_forward_calls(smoke):
        feats, rois, levels, strides, out_size, ratio = args[:6]
        b, r = levels.shape
        n = 20 if b == 1 else 5

        def call():
            return ra.roi_align(*args)
        got = call()
        want = ra.roi_align_plain(*args)
        feat_max = max(float(f.float().abs().max()) for f in feats)
        err = float((got - want).abs().max())
        differ = int((got != want).sum())
        del got, want
        shapes = [tuple(f.shape[2:]) for f in feats]
        n_samples, n_off = smoke.roi_sample_stats(
            torch, rois, levels, shapes, out_size=out_size, ratio=ratio)
        nbytes, ops = smoke.roi_align_cost(torch, feats, rois, levels,
                                           out_size, ratio)
        bound, bound_by = smoke.bound_of(nbytes, ops)
        graph = smoke.graph_ms(torch, call, n)
        events = smoke.events_ms(torch, call, n)
        plain = smoke.events_ms(torch, lambda: ra.roi_align_plain(*args), 1)
        parts = {v: None if lib is None else with_lib(
            'roi_align', lib, lambda: smoke.graph_ms(torch, call, n))
            for v, lib in variants.items()}
        row = dict(call=name, batch=b, rois=r, out=out_size,
                   maps=str(feats[0].dtype),
                   extent_px=roi_extent(rois, levels),
                   per_level=torch.bincount(levels.flatten().long(),
                                            minlength=4).tolist(),
                   samples_off_map=n_off / max(n_samples, 1),
                   graph_ms=graph, events_ms=events, plain_ms=plain,
                   bound_ms=bound, bound_by=bound_by, bound_bytes=nbytes,
                   ops=ops, max_abs_err=err, limit=1e-6 * feat_max,
                   elements_differ=differ, **{f'{v}_ms': t for v, t in
                                              parts.items()})
        rows.append(row)
        print(f'probe 7: {name} B={b} R={r} out {out_size} {feats[0].dtype} '
              f'levels {row["per_level"]}, {row["samples_off_map"]:.2%} of '
              f'the samples off their map: {graph:.4f} ms (graph), '
              f'{events:.4f} (events); RoI extent on its level (10/50/90 %) '
              f'{row["extent_px"]}; plain {plain:.2f}; bound '
              f'{bound:.4f} ({bound_by}; {nbytes} bytes); max_abs_err '
              f'{err:.3e} (limit {1e-6 * feat_max:.3e}), {differ} elements '
              f'differ from plain; ' + ', '.join(
                  f'{v} {fmt(t)}' for v, t in parts.items()), flush=True)
        if err > 1e-6 * feat_max:
            raise RuntimeError(f'probe 7: {name}: kernel and plain differ '
                               f'beyond 1e-6 * max|feat|')
        del args
        torch.cuda.empty_cache()
    report['roi_align'] = rows


# edits of csrc/carafe.cu for part 10b: one pass of the backward skipped
# (the call's time is then the other pass), and the parent's float32
# weight scratch taken out of both passes (pass 1 stores no weights, pass
# 2 reads a constant); one edit set for each design measured
CARAFE_BACKWARD_PARTS = {
    'logits_pass_only': ({'carafe_backward_x_kernel<':
                          'if (false) carafe_backward_x_kernel<'},),
    'x_pass_only': ({'carafe_backward_logits_kernel<':
                     'if (false) carafe_backward_logits_kernel<'},),
    'no_weight_scratch': (
        {'wts[(n * kTaps + k) * hw2 + pix] = wt[k];': ';',
         'wv[q] = wts[(n * kTaps + k) * hw2 + p[q]];': 'wv[q] = 0.04f;'},),
    # the redesign's parts: the dlogits launch without its dw sums, and
    # without its softmax epilogue; the dx launch with adds for its
    # multiply-adds (no gather weights)
    'logits_no_sums': (
        {'dw[k][0] = __fmaf_rn(g0.x, v, dw[k][0]);': '',
         'dw[k][1] = __fmaf_rn(g0.y, v, dw[k][1]);': '',
         'dw[k][2] = __fmaf_rn(g1.x, v, dw[k][2]);': '',
         'dw[k][3] = __fmaf_rn(g1.y, v, dw[k][3]);':
         'dw[k][3] = __fadd_rn(dw[k][3], g1.y);'},),
    'logits_no_softmax': (
        {'softmax_weights(logits + base, hw, wt);':
         'for (int k = 0; k < kTaps; ++k) wt[k] = 0.04f;'},),
    'no_copies': (  # the copies' PTX made comments
        {'cp.async.ca.shared.global [%0], [%1], 4, %2;':
         '// [%0], [%1], 4, %2;',
         'cp.async.ca.shared.global [%0], [%1], 8, %2;':
         '// [%0], [%1], 8, %2;'},),
    'x_no_weights': (
        {'a[0] = __fmaf_rn(wq[k][0], g0.x, a[0]);': 'a[0] += g0.x;',
         'a[1] = __fmaf_rn(wq[k][1], g0.y, a[1]);': 'a[1] += g0.y;',
         'a[2] = __fmaf_rn(wq[k][2], g0.z, a[2]);': 'a[2] += g0.z;',
         'a[3] = __fmaf_rn(wq[k][3], g0.w, a[3]);': 'a[3] += g0.w;',
         'b[0] = __fmaf_rn(wq[k][0], g1.x, b[0]);': 'b[0] += g1.x;',
         'b[1] = __fmaf_rn(wq[k][1], g1.y, b[1]);': 'b[1] += g1.y;',
         'b[2] = __fmaf_rn(wq[k][2], g1.z, b[2]);': 'b[2] += g1.z;',
         'b[3] = __fmaf_rn(wq[k][3], g1.w, b[3]);': 'b[3] += g1.w;'},),
}


def probe_carafe(smoke, report):
    """Row 10b at the 3 calls of one bs-16 800x1344 FPN-CARAFE step (by
    graph replays and events; its passes apart and without the weight
    scratch by ``CARAFE_BACKWARD_PARTS``; the float32 scratch's bytes; the
    bound)."""
    import numpy as np
    cb = importlib.import_module('erd_tpu_torch.ops.carafe')
    calls = smoke.train_step_calls(np, torch, 'carafe', ('carafe_backward',))
    variants = {v: variant_lib('carafe', f'backward_{v}', alts)
                for v, alts in CARAFE_BACKWARD_PARTS.items()}
    rows = []
    for args in sorted(calls['carafe_backward'], key=lambda a: a[0].shape[2]):
        x, logits, g = (a.detach() for a in args[:3])

        def call():
            return cb.carafe_backward(x, logits, g)
        got = call()
        want = cb.carafe_backward_plain(x, logits, g)
        errs = [float((a.float() - w.float()).abs().max()) /
                float(w.float().abs().max()) for a, w in zip(got, want)]
        del got, want
        nbytes, ops, bf16_ops = smoke.carafe_backward_cost(x, logits, g)
        bound, bound_by = smoke.bound_of(nbytes, ops, bf16_ops)
        b, _, h, w = x.shape
        scratch = b * 25 * 4 * h * w * 4
        graph = smoke.graph_ms(torch, call, 10)
        events = smoke.events_ms(torch, call, 10)
        parts = {v: None if lib is None else with_lib(
            'carafe', lib, lambda: smoke.graph_ms(torch, call, 10))
            for v, lib in variants.items()}
        row = dict(x=list(x.shape), graph_ms=graph, events_ms=events,
                   bound_ms=bound, bound_by=bound_by, bound_bytes=nbytes,
                   ops=ops, bf16_ops=bf16_ops,
                   err_over_max_plain=dict(zip(('dx', 'dlogits'), errs)),
                   weight_scratch_bytes=scratch,
                   **{f'{v}_ms': t for v, t in parts.items()})
        rows.append(row)
        print(f'probe 10b: x {tuple(x.shape)} {x.dtype}: {graph:.4f} ms '
              f'(graph), {events:.4f} (events); ' + ', '.join(
                  f'{v} {fmt(t)}' for v, t in parts.items()) +
              f'; the float32 weight scratch {scratch / 1e6:.1f} MB written '
              f'once and read back ({2 * scratch / nbytes:.1%} of the '
              f'bound\'s {nbytes / 1e6:.1f} MB); bound {bound:.4f} '
              f'({bound_by}); dx, dlogits within {errs[0]:.2e}, '
              f'{errs[1]:.2e} of max|plain|', flush=True)
    report['carafe_backward'] = dict(calls=rows, per_step_graph_ms=sum(
        r['graph_ms'] for r in rows))
    del calls
    torch.cuda.empty_cache()


# edits of csrc/carafe.cu for part 10: the forward with its tap loads
# replaced by a value of the channel (the sums left; the redesign's staging
# copies left too), with its stores replaced by a test that keeps the sums
# live, and without its softmax's arithmetic (the parent: constant weights;
# the redesign: the logits read as weights); one edit set for each design
# measured
CARAFE_FORWARD_PARTS = {
    'no_tap_loads': (
        {'in[0] ? widen(plane, off[0]) : 0.f':
         'in[0] ? static_cast<float>(ch & 7) : 0.f',
         'in[k] ? widen(plane, off[k]) : 0.f':
         'in[k] ? static_cast<float>(ch & 3) : 0.f'},
        {'const float v = widen(&xc[ch][ty][tx], 0);':
         'const float v = static_cast<float>(ch & 7);',
         'const float v = widen(&xc[ch][ty + k / kKUp][tx + k % kKUp], 0);':
         'const float v = static_cast<float>((ch + k) & 7);'}),
    'no_store': (
        {'store(out, (n * c + ch) * hw2 + pix, acc);':
         'if (acc == 12345.f) store(out, (n * c + ch) * hw2 + pix, acc);'},
        {'store_pair(o, a[0], a[1]);':
         'if ((a[0] == 12345.f) | (a[1] == 12345.f))\n'
         '          store_pair(o, 0.f, 0.f);',
         'store_pair(o + w2, a[2], a[3]);':
         'if ((a[2] == 12345.f) | (a[3] == 12345.f))\n'
         '          store_pair(o, 0.f, 0.f);'}),
    'no_softmax': (
        {'softmax_weights(lg, hw, wt);':
         'for (int k = 0; k < kTaps; ++k) wt[k] = 0.04f;'},
        {'softmax_weights(lg + q * kTaps * hw, hw, wt[q]);':
         'for (int k = 0; k < kTaps; ++k)\n'
         '        wt[q][k] = widen(lg + q * kTaps * hw, k * hw);'}),
}


def carafe_forward_calls(smoke):
    """[(name, x, logits)]: part 10's CARAFE forward calls, the 3 of one
    bs-16 800x1344 FPN-CARAFE step and the 3 of one 800x1333 request (the
    content encoders arranged, as ``chip_smoke.py`` checks them)."""
    import numpy as np
    cb = importlib.import_module('erd_tpu_torch.ops.carafe')
    out = []
    got = smoke.train_step_calls(np, torch, 'carafe', ('carafe',))
    for args in sorted(got['carafe'], key=lambda a: a[0].shape[2]):
        x, logits = (a.detach() for a in args[:2])
        out.append((f'train {x.shape[2]}x{x.shape[3]}', x, logits))
    del got
    det, net = smoke.carafe_net(np, torch, 'carafe')
    batch, _ = smoke.request_batch(np, torch, smoke.REQUESTS[-1])
    seen = []
    restore = smoke.capture(cb, 'carafe', seen)
    try:
        det.predict(net, batch)
    finally:
        restore()
    for args in sorted(seen, key=lambda a: a[0].shape[2]):
        x, logits = (a.detach() for a in args[:2])
        out.append((f'serve {x.shape[2]}x{x.shape[3]}', x, logits))
    del det, net, seen
    torch.cuda.empty_cache()
    return out


def probe_carafe_forward(smoke, report):
    """Row 10 at every call of ``carafe_forward_calls``: the call by
    graph replays and events, the plain version's time, the bound as
    ``chip_smoke.carafe_cost`` counts it, the elements where kernel and
    plain differ and the largest bf16 ulp distance, and the
    ``CARAFE_FORWARD_PARTS`` variants by graph replays."""
    cb = importlib.import_module('erd_tpu_torch.ops.carafe')
    variants = {v: variant_lib('carafe', f'forward_{v}', alts)
                for v, alts in CARAFE_FORWARD_PARTS.items()}
    rows = []
    for name, x, logits in carafe_forward_calls(smoke):
        n = 10 if x.shape[0] > 1 else 20

        def call():
            return cb.carafe(x, logits)
        got = call()
        want = cb.carafe_plain(x, logits)
        differ = int((got != want).sum())
        ulps = int(smoke.bf16_ulps(torch, got, want).max()) \
            if x.dtype == torch.bfloat16 else None
        del got, want
        nbytes, ops = smoke.carafe_cost(x, logits)
        bound, bound_by = smoke.bound_of(nbytes, ops)
        graph = smoke.graph_ms(torch, call, n)
        events = smoke.events_ms(torch, call, n)
        plain = smoke.events_ms(torch, lambda: cb.carafe_plain(x, logits), 2)
        parts = {v: None if lib is None else with_lib(
            'carafe', lib, lambda: smoke.graph_ms(torch, call, n))
            for v, lib in variants.items()}
        rows.append(dict(call=name, x=list(x.shape), dtype=str(x.dtype),
                         graph_ms=graph, events_ms=events, plain_ms=plain,
                         bound_ms=bound, bound_by=bound_by,
                         bound_bytes=nbytes, ops=ops,
                         elements_differ=differ, max_bf16_ulps=ulps,
                         **{f'{v}_ms': t for v, t in parts.items()}))
        print(f'probe 10: {name} x {tuple(x.shape)} {x.dtype}: {graph:.4f} '
              f'ms (graph), {events:.4f} (events); plain {plain:.3f}; bound '
              f'{bound:.4f} ({bound_by}; {nbytes} bytes, {ops / 1e9:.3f} '
              f'GOP); {differ} elements differ from plain, at most {ulps} '
              f'bf16 ulp; ' + ', '.join(f'{v} {fmt(t)}'
                                       for v, t in parts.items()),
              flush=True)
    report['carafe'] = dict(calls=rows, per_step_graph_ms=sum(
        r['graph_ms'] for r in rows if r['call'].startswith('train')))
    torch.cuda.empty_cache()


# edits of csrc/point_sample.cu for part 13a-b: the parent design's
# backward with its float atomic adds replaced by plain stores (its sums
# wrong); the tile design's ranks taken by integer atomics in any order
# (the cost of the fixed order; its sums in another order), its gather
# without its gradient loads, and without its shared-memory sums (each
# result wrong); one edit set for each design measured
POINT_BACKWARD_PARTS = {
    'stores_for_adds': (
        {'if (ok00) atomicAdd(m + o00, ': 'if (ok00) *(m + o00) = (',
         'if (ok01) atomicAdd(m + o01, ': 'if (ok01) *(m + o01) = (',
         'if (ok10) atomicAdd(m + o10, ': 'if (ok10) *(m + o10) = (',
         'if (ok11) atomicAdd(m + o11, ': 'if (ok11) *(m + o11) = ('},),
    'atomic_ranks': (
        {'ranks[4 * p + d] = before + __popc(peers & below);':
         'ranks[4 * p + d] = atomicAdd(at, 1);',
         'if (t >= 0 && (peers & below) == 0) *at = before + __popc(peers);':
         ';'},),
    'gather_no_loads': (
        {'      cur[i] = i < cnt ? __ldg(g + static_cast<long long>(rec_p[i]) '
         '* c)\n                       : 0.f;':
         '      cur[i] = static_cast<float>(i);',
         '        nxt[i] = nx < cnt ? __ldg(g + static_cast<long long>('
         'rec_p[nx]) * c)\n                          : 0.f;':
         '        nxt[i] = static_cast<float>(nx & 7);'},),
    'gather_no_sums': (
        {'float s0 = mine[a0], s1 = mine[a1];': 'float s0 = 0.f, s1 = 0.f;',
         'float s2 = mine[a2], s3 = mine[a3];': 'float s2 = 0.f, s3 = 0.f;',
         'mine[a0] = s0;': 'if (s0 == 12345.f) mine[a0] = s0;',
         'mine[a1] = s1;': 'if (s1 == 12345.f) mine[a1] = s1;',
         'mine[a2] = s2;': 'if (s2 == 12345.f) mine[a2] = s2;',
         'mine[a3] = s3;': 'if (s3 == 12345.f) mine[a3] = s3;'},),
}
# 13a-b's device operations, by the profiler's names (a key with no
# record in a design reads "not measured"): the parent's memset, kernel
# and rounding pass; the tile design's memset, rank, scan, scatter and
# gather launches
POINT_BACKWARD_OPS = {
    'zero': ('Memset', 'FillFunctor'),
    'kernel': ('point_sample_backward_kernel',),
    'round': ('copy',),
    'rank': ('point_sample_rank_kernel',),
    'scan': ('point_sample_scan',),
    'scatter': ('point_sample_scatter_kernel',),
    'gather': ('point_sample_gather_kernel',),
}


def corner_stats(points, shape, tile=(8, 32)):
    """The bilinear corners of ``points`` (N, K, 2) on maps of ``shape``
    (align_corners=False): the points an image, the share of corners off
    the map, the corner adds a touched pixel (mean and largest) and the
    share of the maps' tile[0] x tile[1] pixel tiles that a corner
    reaches."""
    n, _, h, w = shape
    k = points.shape[1]
    xs = points[..., 0].double() * w - 0.5
    ys = points[..., 1].double() * h - 0.5
    x0 = torch.floor(xs.clamp(-2, w + 1)).long()
    y0 = torch.floor(ys.clamp(-2, h + 1)).long()
    img = torch.arange(n, device=points.device)[:, None].expand(n, k)
    pix, tiles = [], []
    ty, tx = -(-h // tile[0]), -(-w // tile[1])
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        pix.append(((img * h + yy) * w + xx)[ok])
        tiles.append(((img * ty + yy // tile[0]) * tx + xx // tile[1])[ok])
    pix = torch.cat(pix)
    counts = torch.bincount(pix, minlength=n * h * w)
    touched = counts[counts > 0]
    # corners a kernel tile of 8 x 8 pixels takes
    t8 = ((pix // (h * w)) * -(-h // 8) + pix % (h * w) // w // 8) * \
        -(-w // 8) + pix % w // 8
    tile8 = torch.bincount(t8)
    return dict(points_per_image=k,
                corners_off_map=1.0 - pix.numel() / (4 * n * k),
                adds_per_touched_pixel_mean=float(touched.double().mean())
                if touched.numel() else 0.0,
                adds_per_touched_pixel_max=int(counts.max()),
                touched_pixels=touched.numel() / (n * h * w),
                tiles_reached=torch.unique(torch.cat(tiles)).numel() /
                (n * ty * tx),
                corners_per_8x8_tile_mean=float(
                    tile8[tile8 > 0].double().mean()) if pix.numel() else 0.0,
                corners_per_8x8_tile_max=int(tile8.max())
                if pix.numel() else 0)


def probe_point_backward(smoke, report):
    """Row 13a-b at the 2 calls of one bs-16 PointRend step: the call by
    graph replays and events, its device operations apart
    (``POINT_BACKWARD_OPS``, the profiler), the strides of the maps, the
    gradient and the result, ``corner_stats``, and the
    ``POINT_BACKWARD_PARTS`` variants by graph replays."""
    import numpy as np
    sp = importlib.import_module('erd_tpu_torch.ops.sampling')
    got = smoke.mask_train_step_calls(np, torch, 'point_rend',
                                      ('point_sample_backward',))
    variants = {v: variant_lib('point_sample', f'backward_{v}', alts)
                for v, alts in POINT_BACKWARD_PARTS.items()}
    rows = []
    for args in sorted(got['point_sample_backward'],
                       key=lambda a: -a[2][2]):
        args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
        grad, pts, shape, strides, dtype = args[:5]

        def call():
            return sp.point_sample_backward(*args)
        out = call()
        want = sp.point_sample_backward_plain(grad, pts, shape)
        diff = (out.float() - want).abs()
        limit = 1e-5 * float(want.abs().max())
        err = float(diff.max())
        ulps = int(smoke.bf16_ulps(torch, out, want.to(dtype))[
            diff > limit].max()) if dtype == torch.bfloat16 and \
            bool((diff > limit).any()) else 0
        out_stride = list(out.stride())
        again = call()
        same = bool(torch.equal(again, out))
        del out, want, diff, again
        graph = smoke.graph_ms(torch, call, 10)
        events = smoke.events_ms(torch, call, 10)
        ops = device_ops_ms(call, POINT_BACKWARD_OPS)
        stats = corner_stats(pts, shape)
        parts = {v: None if lib is None else with_lib(
            'point_sample', lib, lambda: smoke.graph_ms(torch, call, 10))
            for v, lib in variants.items()}
        row = dict(maps=list(shape), dtype=str(dtype),
                   maps_stride=list(strides),
                   grad_stride=list(grad.stride()), out_stride=out_stride,
                   graph_ms=graph, events_ms=events,
                   **{f'{k}_ms': v for k, v in ops.items()},
                   max_abs_err=err, limit=limit, max_bf16_ulps=ulps,
                   repeat_equal=same, **stats,
                   **{f'{v}_ms': t for v, t in parts.items()})
        rows.append(row)
        print(f'probe 13a-b: maps {shape} {dtype} strides {strides}, grad '
              f'{tuple(grad.shape)} strides {grad.stride()}, result strides '
              f'{tuple(out_stride)}: {graph:.4f} ms (graph), {events:.4f} '
              f'(events); device (profiler): ' + ', '.join(
                  f'{k} {fmt(v)}' for k, v in ops.items()) +
              f'; {stats["points_per_image"]} points an image, '
              f'{stats["corners_off_map"]:.2%} of the corners off the map, '
              f'{stats["adds_per_touched_pixel_mean"]:.2f} corner adds a '
              f'touched pixel (largest {stats["adds_per_touched_pixel_max"]};'
              f' {stats["touched_pixels"]:.1%} of the pixels touched), '
              f'{stats["tiles_reached"]:.1%} of the 8x32 tiles reached, '
              f'{stats["corners_per_8x8_tile_mean"]:.1f} corners an 8x8 tile '
              f'reached (largest {stats["corners_per_8x8_tile_max"]}); '
              f'max_abs_err {err:.3e} (limit {limit:.3e}; bf16 beyond it at '
              f'most {ulps} ulp); two calls equal {same}; ' + ', '.join(
                  f'{v} {fmt(t)}' for v, t in parts.items()), flush=True)
    report['point_sample_backward'] = dict(calls=rows, per_step_graph_ms=sum(
        r['graph_ms'] for r in rows))
    del got
    torch.cuda.empty_cache()


@functools.lru_cache(maxsize=1)
def loss_calls(smoke):
    """{config: {'atss': (args, kwargs), 'gfl_loss': (wide, lo, args,
    kwargs) or None}}: the ATSS and fused GFL-loss calls of one bs-16,
    800x1344 step of ERD stage 2 (``chip_smoke.train_case`` after its
    B = 2 case, as ``phase_train_kernels`` makes them: 1-12 gts an image,
    the loss on the 40 new-class columns of the 80-wide student map), GFL
    R101-DCN (C = 80) and VFNet R50-mdconv (ATSS only), each with its
    phase's own gts. ``wide`` is the (B, N, W) class map whose columns
    lo:lo + C the loss reads. Made once for parts 3 and 6."""
    import numpy as np

    from erd_tpu_torch.engine import batch_to
    from erd_tpu_torch.models.heads import gfl_head, vfnet_head
    from erd_tpu_torch.models.heads.gfl_head import AnchorContext
    out = {}
    rs = np.random.RandomState(5)
    ctx = AnchorContext.build(smoke.TRAIN_CANVAS)
    seen = []
    restore = smoke.capture_kw(gfl_head, 'atss_assign', seen)
    try:
        smoke.train_case(np, torch, rs, ctx, 2)
        case = smoke.train_case(np, torch, rs, ctx, smoke.TRAIN_BATCH)
    finally:
        restore()
    t = case['targets']
    centers, strides = ctx.device_tensors(smoke.DEV)
    out['erd'] = dict(atss=seen[-1], gfl_loss=(
        case['s_cls'], smoke.OLD_CLASSES,
        (case['s_reg'], t.labels, t.label_weights, t.bbox_targets,
         t.pos_mask, t.num_pos, centers, strides), {}))
    del case
    for kind in smoke.DCN_CONFIGS:
        _, det, net = smoke.dcn_train_net(torch, kind)
        batch = batch_to(next(iter(smoke.SyntheticLoader(
            np, torch, 1, seed=41, num_labels=smoke.NUM_CLASSES).epoch(0))),
            smoke.DEV)
        atss, gfl = [], []
        head = vfnet_head if kind.startswith('vfnet') else gfl_head
        undo = [smoke.capture_kw(head, 'atss_assign', atss),
                smoke.capture_kw(gfl_head, 'fused_gfl_loss', gfl)]
        try:
            losses = det.loss(net, batch)
            sum(losses.values()).backward()
        finally:
            for u in undo:
                u()
        torch.cuda.synchronize()
        row = dict(atss=atss[0], gfl_loss=None)
        if gfl:
            args, kwargs = gfl[0]
            row['gfl_loss'] = (args[0].contiguous(), 0, args[1:], kwargs)
        out[kind] = row
        del net, losses, batch, atss, gfl
        torch.cuda.empty_cache()
    return out


def package_source(name):
    """The path of a kernel source: ``csrc/<name>.cu``, or a module of the
    package where ``name`` ends in ``.py`` (``ops/gfl_loss.py``)."""
    from erd_tpu_torch.ops import cuda_build
    if name.endswith('.py'):
        return cuda_build.CSRC.parent / name
    return cuda_build.CSRC / f'{name}.cu'


def module_variant(name, variant, edits):
    """The module ``name`` (``ops/gfl_loss.py``) with each text of
    ``edits`` replaced, imported from the build directory as a sibling of
    the original (its relative imports resolve): a measurement's variant,
    on no path."""
    import importlib.util

    from erd_tpu_torch.ops import cuda_build
    src = package_source(name).read_text()
    for old, new in edits.items():
        if old not in src:
            raise RuntimeError(f'{name}: {old!r} not found')
        src = src.replace(old, new)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = name[:-3].replace('/', '_')
    path = cuda_build.BUILD_DIR / f'{stem}_{variant}.py'
    path.write_text(src)
    parent = 'erd_tpu_torch.' + name[:-3].replace('/', '.').rpartition(
        '.')[0]
    spec = importlib.util.spec_from_file_location(
        f'{parent}.{stem}_{variant}', path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


# edits of ops/gfl_loss.py for part 3, the parent's Triton kernels: the
# launch settings (rows a program, warps), the kernel without its class
# part (no class loads, arithmetic or stores: constant logits) and without
# its distribution part (constant distribution logits, no stores of their
# gradient); the redesign has no Triton kernel, so these fit the parent
# alone
GFL_LOSS_TRITON_PARTS = {
    **{f'rows_{r}': ({'ROWS = 32\n': f'ROWS = {r}\n'},) for r in (8, 16, 64)},
    **{f'warps_{w}': ({'BLOCK_B=triton.next_power_of_2(nbins), num_warps=4)':
                       'BLOCK_B=triton.next_power_of_2(nbins), '
                       f'num_warps={w})'},) for w in (2, 8)},
    'no_class': (
        {'xc = tl.load(cls_ptr + rows64[:, None] * cls_stride + cc, mask=cm,\n'
         '                     other=0.0)':
         'xc = tl.zeros((ROWS, BLOCK_C), tl.float32) - 3.0',
         'tl.store(gcls_ptr + rows64[:, None] * C + cc, gc, mask=cm)':
         'pass'},),
    'no_distribution': (
        {'x = tl.load(reg_ptr + roff, mask=m3, other=0.0)':
         'x = tl.zeros((ROWS, 4, BLOCK_B), tl.float32) + jj.to(tl.float32)',
         'tl.store(greg_ptr + roff, g_int + g_dfl, mask=m3)': 'pass'},),
}
# edits of csrc/gfl_loss.cu for part 3, the redesign: the kernels without
# their class part (constant logits, no gradient stores) and without their
# distribution part (constant distribution logits, no stores of their
# gradient, zeros included)
GFL_LOSS_PARTS = {
    'no_class': (
        {'const float4 v = x4[j];':
         'const float4 v = make_float4(-3.f, -3.f, -3.f, -3.f);',
         'g4[j] = d;': '(void)d;',
         'qfl_term<kBeta2>(xr[c], c == lab':
         'qfl_term<kBeta2>(-3.f, c == lab',
         'gr[c] = qfl_grad<kBeta2>(xr[c], c == lab, q, p.beta, smax) * kcl;':
         'smax = fmaxf(smax, -3.f);'},),
    'no_distribution': (
        {'for (int j = 0; j < p.nb; ++j) mx = fmaxf(mx, x[j]);': 'mx = 0.f;',
         'const float e = __expf(x[j] - mx);':
         'const float e = __expf(-0.1f * j);',
         'dfl = g.wl * (g.lse - x[g.dli]) + g.wr * (g.lse - x[g.dri]);':
         'dfl = (g.wl + g.wr) * g.lse;',
         'const float pj = __expf(x[j] - g.mx) * inv;':
         'const float pj = __expf(-0.1f * j) * inv;',
         'if (first + i < total4) g4[i]': 'if (first + i < 0) g4[i]',
         'for (int j = 0; j < p.nb; ++j) out[j] = 0.f;': ';',
         'out[j] = g_int + ((g.wl + g.wr) * pj - hit) * kdw;':
         'if (g_int == 12345.f) out[j] = hit * kdw;'},),
}
# edits of csrc/atss.cu for part 6: the candidates without the per-gt
# statistics (the parent: thread 0's serial IoUs, mean, std and atomics
# skipped; the redesign: its select kernel's mean and std, the threshold
# left at 0), and the redesign's scan on chunks of 1024 and 4096 anchors;
# one edit set for each design measured
ATSS_PARTS = {
    'no_stats': (
        {'if (threadIdx.x != 0) return;': 'return;'},
        {'  if (lane == 0) {\n    float sum = 0.f, cnt = 0.f;':
         '  if (lane == 32) {\n    float sum = 0.f, cnt = 0.f;'}),
    **{f'chunk_{c}': ({'constexpr int kChunk = 2048;':
                      f'constexpr int kChunk = {c};'},) for c in (1024, 4096)},
}
# row 3's and row 6's device operations by the profiler's names (a key
# with no record in a design reads "not measured")
GFL_LOSS_OPS = {
    'rows': ('_gfl_loss_kernel', 'gfl_loss_rows_kernel'),
    'reduce': ('_gfl_reduce_kernel', 'gfl_loss_reduce_kernel'),
    'backward': ('gfl_loss_backward_kernel',),
}
ATSS_OPS = {
    'zero': ('Memset',),
    'candidates': ('atss_candidates_kernel',),
    'scan': ('atss_scan_kernel',),
    'select': ('atss_select_kernel',),
    'resolve': ('atss_resolve_kernel',),
}


def fit_variants(name, tables, build):
    """{variant: built or None} over each table of edit sets whose
    ``fitting_edits`` fits ``name`` (None where none does)."""
    out = {}
    for table in tables:
        for variant, alternatives in table.items():
            edits = fitting_edits(name, alternatives)
            out[variant] = None if edits is None else build(variant, edits)
    return out


def ptxas_resources(name):
    """{kernel: {'regs', 'spills'}} from ptxas's report of this process's
    build of ``csrc/<name>.cu`` (empty where it did not build it)."""
    import re

    from erd_tpu_torch.ops import cuda_build
    out, current = {}, None
    for line in cuda_build.BUILD_LOGS.get(name, '').splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r'Used (\d+) registers', line)
        if m and current:
            out.setdefault(current, {})['regs'] = int(m.group(1))
        m = re.search(r'(\d+) bytes spill stores', line)
        if m and current:
            out.setdefault(current, {})['spills'] = int(m.group(1))
    return out


def kernel_resources(compiled, source='gfl_loss'):
    """{kernel: {'regs', 'spills'}} of row 3's (or row 4's) kernels:
    Triton's own ``n_regs`` and ``n_spills`` of each specialisation
    launched (the parent's ``compiled`` kernels), or ptxas's of
    ``csrc/<source>.cu``."""
    if compiled:
        return {f'{k.name}[{i}]': dict(regs=k.n_regs, spills=k.n_spills)
                for i, k in enumerate(compiled)}
    return ptxas_resources(source)


def record_triton(gl, compiled, name='_gfl_loss_kernel'):
    """Wrap the parent's Triton kernel ``name`` of module ``gl`` (once
    built) so that each launch's compiled kernel lands in ``compiled``; a
    no-op for a module without one. Returns the restore function."""
    kern = getattr(gl, name, None)
    if kern is None:
        return lambda: None

    class Recorder:
        def __getitem__(self, grid):
            def launch(*args, **kwargs):
                k = kern[grid](*args, **kwargs)
                if all(k is not c for c in compiled):
                    compiled.append(k)
                return k
            return launch
    setattr(gl, name, Recorder())
    return lambda: setattr(gl, name, kern)


def probe_gfl_loss(smoke, report):
    """Row 3 at the fused GFL-loss calls of one ERD and one GFL R101-DCN
    step (``loss_calls``): the forward alone and forward + backward
    (``torch.autograd.grad`` of the losses' sum) by graph replays and
    events, the copies autograd adds around a class slice (the zero-fill
    of the wide map's gradient and the slice copy), the kernels by the
    profiler (``GFL_LOSS_OPS``), the registers and spills of each kernel,
    the plain version's forward + backward, the bound
    (``chip_smoke.gfl_loss_cost``), the losses' and gradients' error
    against plain, and the ``GFL_LOSS_TRITON_PARTS`` / ``GFL_LOSS_PARTS``
    variants by graph replays."""
    gl = importlib.import_module('erd_tpu_torch.ops.gfl_loss')
    calls = loss_calls(smoke)
    triton_variants = fit_variants(
        'ops/gfl_loss.py', (GFL_LOSS_TRITON_PARTS,),
        lambda v, e: module_variant('ops/gfl_loss.py', v, e))
    cuda_variants = fit_variants(
        'gfl_loss', (GFL_LOSS_PARTS,),
        lambda v, e: edited_lib('gfl_loss', f'gfl_{v}', e))
    compiled = []
    rows = []
    for kind, got in calls.items():
        if got['gfl_loss'] is None:
            continue
        wide0, lo, rest, kwargs = got['gfl_loss']
        b, n, w = wide0.shape
        c = smoke.NUM_CLASSES - lo if lo else w
        reg0 = rest[0]
        wide = wide0.clone().requires_grad_(True)
        reg = reg0.clone().requires_grad_(True)

        def forward(fn=gl.fused_gfl_loss):
            with torch.no_grad():
                return fn(wide[..., lo:lo + c], reg, *rest[1:], **kwargs)

        def both(fn=gl.fused_gfl_loss):
            losses = fn(wide[..., lo:lo + c], reg, *rest[1:], **kwargs)
            return losses, torch.autograd.grad(sum(losses), (wide, reg))

        def copies():
            z = torch.zeros_like(wide0)
            z[..., lo:lo + c].copy_(wide0[..., lo:lo + c])
            return z
        forward()
        restore = record_triton(gl, compiled)
        try:
            (l1, g1), (l2, g2) = both(), both()
        finally:
            restore()
        (lp, gp) = both(gl.gfl_loss_plain)
        l1, lp = torch.stack(l1).detach(), torch.stack(lp).detach()
        loss_err = float(((l1 - lp).abs() / lp.abs().clamp(min=1e-30)).max())
        grad_ratio = max(float(((g - p).abs() / (1e-4 * p.abs() + 1e-5 *
                                                 float(p.abs().max()))).max())
                         for g, p in zip(g1, gp))
        other = float(g1[0][..., :lo].abs().max()) if lo else 0.0
        same = bool(torch.equal(l1, torch.stack(l2)) and all(
            torch.equal(x, y) for x, y in zip(g1, g2)))
        del l1, l2, g1, g2, lp, gp
        fwd = smoke.graph_ms(torch, forward, 10)
        full = smoke.graph_ms(torch, both, 10)
        cp = smoke.graph_ms(torch, copies, 10)
        ev_fwd = smoke.events_ms(torch, forward, 10)
        ev_full = smoke.events_ms(torch, both, 10)
        ops_fwd = device_ops_ms(forward, GFL_LOSS_OPS)
        ops_full = device_ops_ms(both, GFL_LOSS_OPS)
        plain = smoke.events_ms(torch, lambda: both(gl.gfl_loss_plain), 2)
        nbytes, ops = smoke.gfl_loss_cost(b, n, c, reg0.shape[2],
                                          int(rest[4].sum()))
        bound, bound_by = smoke.bound_of(nbytes, ops)
        parts = {}
        for v, mod in triton_variants.items():
            parts[v] = None if mod is None else (
                smoke.graph_ms(torch, lambda: forward(mod.fused_gfl_loss),
                               10),
                smoke.graph_ms(torch, lambda: both(mod.fused_gfl_loss), 10))
        for v, lib in cuda_variants.items():  # a parent's Triton figure stays
            if lib is None:
                parts.setdefault(v, None)
                continue
            parts[v] = with_lib(
                'gfl_loss', lib, lambda: (smoke.graph_ms(torch, forward, 10),
                                          smoke.graph_ms(torch, both, 10)))
        kernels = sum(v for v in ops_full.values() if v)
        rows.append(dict(
            config=kind, batch=b, anchors=n, classes=c, map_width=w,
            positives=int(rest[4].sum()), forward_graph_ms=fwd,
            forward_backward_graph_ms=full, copies_graph_ms=cp,
            backward_graph_ms=full - fwd - cp, forward_events_ms=ev_fwd,
            forward_backward_events_ms=ev_full,
            **{f'fwd_{k}_ms': v for k, v in ops_fwd.items()},
            **{f'fwd_bwd_{k}_ms': v for k, v in ops_full.items()},
            kernels_ms=kernels, plain_ms=plain, bound_ms=bound,
            bound_by=bound_by, bound_bytes=nbytes, ops=ops,
            loss_rel_err=loss_err, grad_err_over_tolerance=grad_ratio,
            other_columns_max=other, repeat_equal=same,
            **{f'{v}_ms': t for v, t in parts.items()}))
        print(f'probe 3: {kind} B={b} N={n} C={c} of a {w}-wide map '
              f'({rows[-1]["positives"]} positives): forward {fwd:.4f} ms, '
              f'forward + backward {full:.4f} (graph; events {ev_fwd:.4f} / '
              f'{ev_full:.4f}), autograd\'s zero-fill + slice copy '
              f'{cp:.4f}; kernels (profiler) forward ' + ', '.join(
                  f'{k} {fmt(v)}' for k, v in ops_fwd.items()) +
              '; forward + backward ' + ', '.join(
                  f'{k} {fmt(v)}' for k, v in ops_full.items()) +
              f' (sum {kernels:.4f}); plain {plain:.3f}; bound {bound:.4f} '
              f'({bound_by}); loss rel err {loss_err:.2e}, gradient error / '
              f'tolerance {grad_ratio:.3f}, other columns {other}, two calls '
              f'equal {same}; variants (forward, forward + backward): ' +
              ', '.join(f'{v} ' + ('not measured' if t is None else
                                   f'{t[0]:.4f} {t[1]:.4f}')
                        for v, t in parts.items()), flush=True)
        del wide, reg
    res = kernel_resources(compiled)
    print('probe 3: registers and spills ' + json.dumps(res), flush=True)
    report['gfl_loss'] = dict(calls=rows, resources=res)
    torch.cuda.empty_cache()


def probe_atss(smoke, report):
    """Row 6 at the ATSS calls of one ERD, GFL R101-DCN and VFNet step
    (``loss_calls``): the real gts and padded slots, the call by graph
    replays and events, its device operations by the profiler
    (``ATSS_OPS``), the plain version's time, the bound
    (``chip_smoke.atss_cost``), the elements that differ from plain, and
    the ``ATSS_PARTS`` variants by graph replays."""
    from erd_tpu_torch.task import atss as atss_module
    calls = loss_calls(smoke)
    variants = fit_variants('atss', (ATSS_PARTS,),
                            lambda v, e: edited_lib('atss', f'atss_{v}', e))
    rows = []
    for kind, got in calls.items():
        args, kwargs = got['atss']

        def call():
            return atss_module.atss_assign(*args, **kwargs)
        res = call()
        want = atss_module.atss_assign_plain(*args, **kwargs)
        fields = ('pos_mask', 'gt_idx', 'labels', 'max_overlaps')
        differ = sum(int((getattr(res, f) != getattr(want, f)).sum())
                     for f in fields)
        positives = int(res.pos_mask.sum())
        del res, want
        anchors, nla, gtb, _, gtm = args[:5]
        b, g = gtm.shape
        real = int(gtm.sum())
        graph = smoke.graph_ms(torch, call, 20)
        events = smoke.events_ms(torch, call, 20)
        ops = device_ops_ms(call, ATSS_OPS, 10)
        plain = smoke.events_ms(
            torch, lambda: atss_module.atss_assign_plain(*args, **kwargs), 2)
        nbytes, nops = smoke.atss_cost(anchors.shape[0], b, g, real)
        bound, bound_by = smoke.bound_of(nbytes, nops)
        parts = {v: None if lib is None else with_lib(
            'atss', lib, lambda: smoke.graph_ms(torch, call, 20))
            for v, lib in variants.items()}
        rows.append(dict(config=kind, batch=b, anchors=anchors.shape[0],
                         levels=list(nla), topk=kwargs.get('topk', 9),
                         gt_slots=b * g, real_gts=real, positives=positives,
                         graph_ms=graph, events_ms=events,
                         **{f'{k}_ms': v for k, v in ops.items()},
                         plain_ms=plain, bound_ms=bound, bound_by=bound_by,
                         elements_differ=differ,
                         **{f'{v}_ms': t for v, t in parts.items()}))
        print(f'probe 6: {kind} B={b} N={anchors.shape[0]} levels '
              f'{list(nla)}: {real} real gts of {b * g} slots, {positives} '
              f'positives: {graph:.4f} ms (graph), {events:.4f} (events); '
              f'device (profiler): ' + ', '.join(
                  f'{k} {fmt(v)}' for k, v in ops.items()) +
              f'; plain {plain:.3f}; bound {bound:.4f} ({bound_by}); '
              f'{differ} elements differ from plain; ' + ', '.join(
                  f'{v} {fmt(t)}' for v, t in parts.items()), flush=True)
    res = ptxas_resources('atss')
    print('probe 6: registers and spills ' + json.dumps(res), flush=True)
    report['atss'] = dict(calls=rows, resources=res)
    torch.cuda.empty_cache()



@functools.lru_cache(maxsize=1)
def distill_calls(smoke):
    """The ERS and fused-distillation inputs of one bs-16, 800x1344 ERD
    step: ``chip_smoke.train_case`` at B = 16 after its B = 2 case (as
    ``phase_train_kernels`` makes them), the teacher's ERS at cap = N // 5
    + 1 and the rows the distillation NMS keeps on the fast branch (the
    first 1024 candidates, IoU 0.005), the masks from the plain versions so
    that every design gets the same inputs. Made once for parts 4 and 5."""
    import numpy as np

    from erd_tpu_torch.models.detectors.gfl_erd import _kept_dense
    from erd_tpu_torch.models.heads.gfl_head import AnchorContext
    from erd_tpu_torch.ops.ers_select import ers_select_plain
    rs = np.random.RandomState(5)
    ctx = AnchorContext.build(smoke.TRAIN_CANVAS)
    smoke.train_case(np, torch, rs, ctx, 2)
    case = smoke.train_case(np, torch, rs, ctx, smoke.TRAIN_BATCH)
    n = ctx.num_anchors
    cap = n // 5 + 1
    centers, _ = ctx.device_tensors(smoke.DEV)
    unit = torch.ones((n,), device=smoke.DEV)
    cm, ri, rm, _ = ers_select_plain(case['t_cls'], case['t_reg'], cap)
    kept = _kept_dense(centers, unit, case['t_cls'], case['t_reg'],
                       ri[:, :1024].contiguous(), rm[:, :1024].contiguous(),
                       0.005, 16)
    torch.cuda.synchronize()
    return dict(s_cls=case['s_cls'], s_reg=case['s_reg'],
                t_cls=case['t_cls'], t_reg=case['t_reg'], cap=cap,
                cls_mask=cm, kept=kept)


# edits of ops/erd_distill.py for part 4, the parent's Triton kernels: the
# launch settings (rows a program, warps), the kernels without their class
# part (constant logits, no class gradient stores) and without their
# distribution part (constant distribution logits, no stores of their
# gradient); the redesign has no Triton kernel, so these fit the parent
# alone
DISTILL_TRITON_PARTS = {
    **{f'rows_{r}': ({'ROWS = 32\n': f'ROWS = {r}\n'},) for r in (8, 16)},
    **{f'warps_{w}': ({'BLOCK_B=triton.next_power_of_2(nbins), num_warps=4)':
                       'BLOCK_B=triton.next_power_of_2(nbins), '
                       f'num_warps={w})'},) for w in (2, 8)},
    'no_class': (
        {'xs = tl.load(s_cls_ptr + rows64[:, None] * s_row_stride + cc,\n'
         '                     mask=s_m, other=0.0)':
         'xs = tl.zeros((ROWS, BLOCK_C), tl.float32) - 3.0',
         'xt = tl.load(t_cls_ptr + rows64[:, None] * C + cc,\n'
         '                     mask=cm[:, None] & cval, other=0.0)':
         'xt = tl.zeros((ROWS, BLOCK_C), tl.float32) - 2.0',
         'tl.store(g_cls_ptr + rows64[:, None] * C + cc, gc,\n'
         '                     mask=rmask[:, None] & cval)': 'pass'},),
    'no_distribution': (
        {'ys = tl.load(s_reg_ptr + roff, mask=m3, other=0.0) / T':
         'ys = tl.zeros((ROWS, 4, BLOCK_B), tl.float32) + '
         'jj.to(tl.float32) / T',
         'yt = tl.load(t_reg_ptr + roff, mask=m3, other=0.0) / T':
         'yt = tl.zeros((ROWS, 4, BLOCK_B), tl.float32) - '
         'jj.to(tl.float32) / T',
         'tl.store(g_reg_ptr + roff, gr, mask=rmask[:, None, None] & jval)':
         'pass'},),
}
# edits of csrc/erd_distill.cu for part 4, the redesign: the kernels
# without their class part (constant logits, no class gradient stores of
# selected rows), without their distribution part (the distribution logits
# of row 0, no stores of their gradient, zeros included), and with the
# backward's gradient stores marked streaming (evict first, __stcs)
DISTILL_PARTS = {
    'no_class': (
        {'const float4 v = s4[j];':
         'const float4 v = make_float4(-3.f, -3.f, -3.f, -3.f);',
         'const float4 u = t4[j];':
         'const float4 u = make_float4(-2.f, -2.f, -2.f, -2.f);',
         'g4[j] = d;': '(void)d;'},),
    'no_distribution': (
        {'p.s_reg + (row * 4 + (lane >> 3)) * p.nb':
         'p.s_reg + (lane >> 3) * p.nb',
         'p.t_reg + (row * 4 + (lane >> 3)) * p.nb':
         'p.t_reg + (lane >> 3) * p.nb',
         'zero_span(greg + first * 4 * p.nb, rows * 4 * p.nb, lane);': ';',
         'out[j] = (pj * st - tj) * k;':
         'if (pj == 12345.f) out[j] = tj * k;'},),
    'streaming_stores': (
        {'b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);':
         '__stcs(b4 + i, make_float4(0.f, 0.f, 0.f, 0.f));',
         'g4[j] = d;': '__stcs(g4 + j, d);',
         'out[j] = (pj * st - tj) * k;':
         '__stcs(out + j, (pj * st - tj) * k);'},),
}
# edits of csrc/ers_select.cu for part 5: the criteria launch alone (the
# later launches skipped), and alone with its stores replaced by a test
# that keeps the maxima live (its read time); one edit set for each design
ERS_PARTS = {
    'criteria_only': (
        {'ers_stats_kernel<<<batch, kStatThreads, 0, s>>>(':
         'if (false) ers_stats_kernel<<<batch, kStatThreads, 0, s>>>(',
         'ers_compact_kernel<<<grid, kThreads, 0, s>>>(':
         'if (false) ers_compact_kernel<<<grid, kThreads, 0, s>>>(',
         'ers_rank_kernel<<<grid, kThreads, 0, s>>>(':
         'if (false) ers_rank_kernel<<<grid, kThreads, 0, s>>>('},
        {'ers_select_kernel<<<batch, kSelThreads, staged, s>>>(':
         'if (false) ers_select_kernel<<<batch, kSelThreads, staged, s>>>(',
         'ers_rank_kernel<<<rgrid, kThreads, 0, s>>>(':
         'if (false) ers_rank_kernel<<<rgrid, kThreads, 0, s>>>('}),
    'criteria_no_stores': (
        {'ers_stats_kernel<<<batch, kStatThreads, 0, s>>>(':
         'if (false) ers_stats_kernel<<<batch, kStatThreads, 0, s>>>(',
         'ers_compact_kernel<<<grid, kThreads, 0, s>>>(':
         'if (false) ers_compact_kernel<<<grid, kThreads, 0, s>>>(',
         'ers_rank_kernel<<<grid, kThreads, 0, s>>>(':
         'if (false) ers_rank_kernel<<<grid, kThreads, 0, s>>>(',
         '  crit[(static_cast<size_t>(b) * 2) * n + i] = c;\n'
         '  crit[(static_cast<size_t>(b) * 2 + 1) * n + i] = r;\n'
         '  keys[row] = order_key(r);':
         '  if (c == 12345.f && r == 12345.f) keys[row] = 0u;'},
        {'ers_select_kernel<<<batch, kSelThreads, staged, s>>>(':
         'if (false) ers_select_kernel<<<batch, kSelThreads, staged, s>>>(',
         'ers_rank_kernel<<<rgrid, kThreads, 0, s>>>(':
         'if (false) ers_rank_kernel<<<rgrid, kThreads, 0, s>>>(',
         '    crit_c[g0 + lane] = c;\n    okeys[g0 + lane] = ok;':
         '    if (c == 12345.f && ok == 7u) okeys[g0 + lane] = ok;'}),
}
# row 4's and row 5's device operations by the profiler's names (the
# parent's Triton forward and backward share one name, so its ``rows`` in
# a forward + backward profile holds both launches)
DISTILL_OPS = {
    'rows': ('_distill_kernel', 'erd_distill_rows_kernel'),
    'reduce': ('_distill_reduce_kernel', 'erd_distill_reduce_kernel'),
    'backward': ('erd_distill_backward_kernel',),
}
ERS_OPS = {
    'memset': ('Memset',),
    'criteria': ('ers_criteria_kernel',),
    'stats': ('ers_stats_kernel',),
    'compact': ('ers_compact_kernel',),
    'select': ('ers_select_kernel',),
    'rank': ('ers_rank_kernel',),
}


def probe_distill(smoke, report):
    """Row 4 at the fused-distillation call of one ERD step
    (``distill_calls``): the ERS-cls, NMS-kept and selected rows an image,
    the forward alone and forward + backward (``torch.autograd.grad`` of
    the losses' sum into the whole 80-wide student map and the
    distribution logits) by graph replays and events, the copies autograd
    adds around a 40-column slice (the zero-fill of the wide gradient and
    the slice copy), the kernels by the profiler (``DISTILL_OPS``), the
    registers and spills, the plain version's forward + backward, both
    bounds (``chip_smoke.erd_distill_cost`` with the class gradient 40 and
    80 columns wide), the errors against plain, the gradient's largest
    entry past column C, two calls' equality, and the
    ``DISTILL_TRITON_PARTS`` / ``DISTILL_PARTS`` variants by graph
    replays."""
    ed = importlib.import_module('erd_tpu_torch.ops.erd_distill')
    got = distill_calls(smoke)
    triton_variants = fit_variants(
        'ops/erd_distill.py', (DISTILL_TRITON_PARTS,),
        lambda v, e: module_variant('ops/erd_distill.py', v, e))
    cuda_variants = fit_variants(
        'erd_distill', (DISTILL_PARTS,),
        lambda v, e: edited_lib('erd_distill', f'distill_{v}', e))
    t_cls, t_reg = got['t_cls'], got['t_reg']
    cm, kept = got['cls_mask'], got['kept']
    s_cls = got['s_cls'].clone().requires_grad_(True)
    s_reg = got['s_reg'].clone().requires_grad_(True)
    b, n, w = s_cls.shape
    c = t_cls.shape[2]

    def forward(fn=ed.fused_erd_distill):
        with torch.no_grad():
            return fn(s_cls, s_reg, t_cls, t_reg, cm, kept)

    def both(fn=ed.fused_erd_distill):
        losses = fn(s_cls, s_reg, t_cls, t_reg, cm, kept)
        return losses, torch.autograd.grad(
            losses[0].sum() + losses[1].sum(), (s_cls, s_reg))

    def copies():
        z = torch.zeros_like(s_cls)
        z[..., :c].copy_(s_cls[..., :c])
        return z
    forward()
    compiled = []
    restore = record_triton(ed, compiled, '_distill_kernel')
    try:
        (l1, g1), (l2, g2) = both(), both()
    finally:
        restore()
    lp, gp = both(ed.erd_distill_plain)
    l1, l2 = torch.stack(l1).detach(), torch.stack(l2).detach()
    lp = torch.stack(lp).detach()
    loss_err = float(((l1 - lp).abs() / lp.abs().clamp(min=1e-30)).max())
    grad_ratio = max(float(((g - p).abs() / (1e-4 * p.abs() + 1e-5 *
                                             float(p.abs().max()))).max())
                     for g, p in zip(g1, gp))
    other = float(g1[0][..., c:].abs().max()) if w > c else 0.0
    same = bool(torch.equal(l1, l2) and all(
        torch.equal(x, y) for x, y in zip(g1, g2)))
    del l1, l2, lp, g1, g2, gp
    rows_cm = cm.sum(1).tolist()
    rows_kp = kept.sum(1).tolist()
    rows_s = (cm | kept).sum(1).tolist()
    fwd = smoke.graph_ms(torch, forward, 10)
    full = smoke.graph_ms(torch, both, 10)
    cp = smoke.graph_ms(torch, copies, 10)
    ev_fwd = smoke.events_ms(torch, forward, 10)
    ev_full = smoke.events_ms(torch, both, 10)
    ops_fwd = device_ops_ms(forward, DISTILL_OPS)
    ops_full = device_ops_ms(both, DISTILL_OPS)
    plain = smoke.events_ms(torch, lambda: both(ed.erd_distill_plain), 2)
    counts = (sum(rows_cm), sum(rows_kp), sum(rows_s))
    bounds = {}
    for width in (c, w):
        nbytes, nops = smoke.erd_distill_cost(b, n, c, width,
                                              t_reg.shape[2], *counts)
        bms, by = smoke.bound_of(nbytes, nops)
        bounds[f'bound_{width}_wide_ms'] = bms
        bounds[f'bound_{width}_wide_by'] = by
        bounds[f'bound_{width}_wide_bytes'] = nbytes
    parts = {}
    for v, mod in triton_variants.items():
        parts[v] = None if mod is None else (
            smoke.graph_ms(torch, lambda: forward(mod.fused_erd_distill), 10),
            smoke.graph_ms(torch, lambda: both(mod.fused_erd_distill), 10))
    for v, lib in cuda_variants.items():  # a parent's Triton figure stays
        if lib is None:
            parts.setdefault(v, None)
            continue
        parts[v] = with_lib(
            'erd_distill', lib, lambda: (smoke.graph_ms(torch, forward, 10),
                                         smoke.graph_ms(torch, both, 10)))
    kernels = sum(v for v in ops_full.values() if v)
    res = kernel_resources(compiled, 'erd_distill')
    report['erd_distill'] = dict(
        batch=b, anchors=n, classes=c, map_width=w, rows_cls=rows_cm,
        rows_kept=rows_kp, rows_selected=rows_s, forward_graph_ms=fwd,
        forward_backward_graph_ms=full, copies_graph_ms=cp,
        forward_events_ms=ev_fwd, forward_backward_events_ms=ev_full,
        **{f'fwd_{k}_ms': v for k, v in ops_fwd.items()},
        **{f'fwd_bwd_{k}_ms': v for k, v in ops_full.items()},
        kernels_ms=kernels, plain_ms=plain, **bounds,
        loss_rel_err=loss_err, grad_err_over_tolerance=grad_ratio,
        other_columns_max=other, repeat_equal=same, resources=res,
        **{f'{v}_ms': t for v, t in parts.items()})
    print(f'probe 4: B={b} N={n} C={c} of a {w}-wide map; rows an image: '
          f'ERS-cls {rows_cm}, kept {rows_kp}, either {rows_s}; forward '
          f'{fwd:.4f} ms, forward + backward {full:.4f} (graph; events '
          f'{ev_fwd:.4f} / {ev_full:.4f}), a zero-fill + slice copy of the '
          f'wide gradient {cp:.4f}; kernels (profiler) forward ' + ', '.join(
              f'{k} {fmt(v)}' for k, v in ops_fwd.items()) +
          '; forward + backward ' + ', '.join(
              f'{k} {fmt(v)}' for k, v in ops_full.items()) +
          f' (sum {kernels:.4f}); plain {plain:.3f}; bound ' + ', '.join(
              f'{width} columns {bounds[f"bound_{width}_wide_ms"]:.4f} '
              f'({bounds[f"bound_{width}_wide_by"]})'
              for width in (c, w)) +
          f'; loss rel err {loss_err:.2e}, gradient error / tolerance '
          f'{grad_ratio:.3f}, columns >= C {other}, two calls equal {same}'
          f'; registers and spills {json.dumps(res)}; variants (forward, '
          f'forward + backward): ' + ', '.join(
              f'{v} ' + ('not measured' if t is None else
                         f'{t[0]:.4f} {t[1]:.4f}')
              for v, t in parts.items()), flush=True)
    del s_cls, s_reg
    torch.cuda.empty_cache()


def probe_ers(smoke, report):
    """Row 5 at the ERS call of the same ERD step (``distill_calls``, cap =
    N // 5 + 1): the candidates an image (rows whose criterion is at least
    the cap-th largest) and the rows tied at the cap-th criterion, the call
    by graph replays and events, its launches and memsets by the profiler
    (``ERS_OPS``), the plain version's time, the bound
    (``chip_smoke.ers_cost``), the list against plain and the masks' flips
    within 1e-6 * |thr|, and the ``ERS_PARTS`` variants (the criteria
    launch alone, and without its stores) by graph replays and the
    profiler."""
    from erd_tpu_torch.ops.ers_select import (ers_select, ers_select_plain,
                                              ers_threshold)
    got = distill_calls(smoke)
    t_cls, t_reg, cap = got['t_cls'], got['t_reg'], got['cap']
    b, n = t_cls.shape[:2]
    variants = fit_variants('ers_select', (ERS_PARTS,),
                            lambda v, e: edited_lib('ers_select',
                                                    f'ers_{v}', e))

    def call():
        return ers_select(t_cls, t_reg, cap)
    res, want = call(), ers_select_plain(t_cls, t_reg, cap)
    list_equal = bool(torch.equal(res[1], want[1]))
    count_ok = bool(torch.equal(res[3].long(), res[2].sum(-1)))
    crit_cls = torch.sigmoid(t_cls).amax(-1)
    crit_reg = t_reg.amax(-1) + 0.0  # -0 counted as +0
    flips = []
    for g, wnt, crit, full in ((res[0], want[0], crit_cls, crit_cls),
                               (res[2], want[2], torch.gather(
                                   crit_reg, 1, want[1]), crit_reg)):
        thr = ers_threshold(full)[:, None]
        near = (crit - thr).abs() <= 1e-6 * thr.abs()
        flips.append((int((g != wnt).sum()), int(((g != wnt) & ~near).sum())))
    kth = torch.sort(crit_reg, dim=1, descending=True)[0][:, cap - 1:cap]
    cands = (crit_reg >= kth).sum(1).tolist()
    tied = (crit_reg == kth).sum(1).tolist()
    count = res[3].tolist()
    del res, want
    graph = smoke.graph_ms(torch, call, 20)
    events = smoke.events_ms(torch, call, 20)
    ops = device_ops_ms(call, ERS_OPS, 10)
    plain = smoke.events_ms(
        torch, lambda: ers_select_plain(t_cls, t_reg, cap), 5)
    nbytes, nops = smoke.ers_cost(b, n, t_cls.shape[2], t_reg.shape[2], cap)
    bound, bound_by = smoke.bound_of(nbytes, nops)
    parts = {v: None if lib is None else with_lib(
        'ers_select', lib, lambda: (smoke.graph_ms(torch, call, 20),
                                    device_ops_ms(call, ERS_OPS, 10)))
        for v, lib in variants.items()}
    resources = ptxas_resources('ers_select')
    report['ers_select'] = dict(
        batch=b, anchors=n, cap=cap, candidates=cands, tied_at_cap=tied,
        count=count, list_equal=list_equal, count_is_mask_sum=count_ok,
        cls_flips=flips[0], reg_flips=flips[1], graph_ms=graph,
        events_ms=events, **{f'{k}_ms': v for k, v in ops.items()},
        plain_ms=plain, bound_ms=bound, bound_by=bound_by,
        bound_bytes=nbytes, resources=resources,
        **{f'{v}_graph_ms': None if t is None else t[0]
           for v, t in parts.items()},
        **{f'{v}_{k}_ms': None if t is None else t[1][k]
           for v, t in parts.items() for k in ERS_OPS})
    print(f'probe 5: B={b} N={n} cap={cap}: candidates an image {cands}, '
          f'rows tied at the cap-th criterion {tied}, count {count}; '
          f'{graph:.4f} ms (graph), {events:.4f} (events); device '
          f'(profiler): ' + ', '.join(f'{k} {fmt(v)}' for k, v in ops.items())
          + f'; plain {plain:.3f}; bound {bound:.4f} ({bound_by}); list '
          f'equal {list_equal}, count = mask sum {count_ok}, mask flips '
          f'(all, outside the band): cls {flips[0]}, reg {flips[1]}; '
          f'registers and spills {json.dumps(resources)}; variants: ' +
          ', '.join(f'{v} ' + ('not measured' if t is None else
                               f'{t[0]:.4f} (graph; ' + ', '.join(
                                   f'{k} {fmt(x)}' for k, x in t[1].items()
                                   if x is not None) + ')')
                    for v, t in parts.items()), flush=True)
    torch.cuda.empty_cache()

# the probe's parts, by the kernel rows of PERF.md
def soft_nms_calls(smoke):
    """{name: the 7 arguments of ``soft_nms``} at the calls part 11a times:
    Faster R-CNN soft's call of one 800x1333 request (K = 2000, linear;
    ``chip_smoke.py``'s fc_cls arrangement), CornerNet's call of one
    768x1024 request (K = 10000, gaussian; heads arranged) and
    ``chip_smoke.soft_nms_large_k_case`` (K = 12000, linear)."""
    import numpy as np

    from erd_tpu_torch.apis import build_detector, init_detector
    from erd_tpu_torch.config import Config
    nms_module = importlib.import_module('erd_tpu_torch.ops.nms')
    out = {}
    det, net, _ = init_detector(smoke.FRCNN_CONFIGS['nms'], device=smoke.DEV)
    batch, _ = smoke.request_batch(np, torch, smoke.REQUESTS[-1])
    smoke.arrange_fc_cls(torch, det, net, batch)
    det.test_cfg = build_detector(Config.fromfile(
        smoke.FRCNN_CONFIGS['soft_nms']).model).test_cfg
    for name in ('frcnn K=2000 linear', 'cornernet K=10000 gaussian'):
        if name.startswith('cornernet'):  # its heads arranged first
            det, net, batch = smoke.cornernet_net(np, torch)
        calls = []
        undo = smoke.capture(nms_module, 'soft_nms', calls)
        try:
            det.predict(net, batch)
        finally:
            undo()
        out[name] = calls[0][:7]
        del det, net, batch, calls
        torch.cuda.empty_cache()
    sboxes, scores = smoke.soft_nms_large_k_case(np, torch)
    out['large K=12000 linear'] = (sboxes, scores, 100, 0.5, 0.5, 1e-3,
                                   'linear')
    return out


# edits of csrc/soft_nms.cu for part 11a: blocks of 1024, 256 and 128
# threads (the per-thread counts scale with them)
SOFT_NMS_PARTS = {
    f'threads_{t}': ({'constexpr int kThreads = 512;':
                      f'constexpr int kThreads = {t};'},)
    for t in (1024, 256, 128)}
# edits of the floor's source (on top of chip_smoke.SOFT_NMS_FLOOR_EDITS)
# that take out one more part of a step: the block's barrier (the words
# race), the warp's reduction (every lane folds its best in), the atomics
# (fixed words stored)
SOFT_NMS_FLOOR_PARTS = {
    'no_barrier': {'    __syncthreads();\n    unsigned long long win = *w;':
                   '    unsigned long long win = *w;'},
    'no_warp_reduce': {
        'const unsigned best = __reduce_max_sync(0xffffffffu, o);':
        'const unsigned best = o;'},
    'no_atomics': {
        '    if (o == best && bkey != kNoKey) atomicMax(w, pack_best(bv, '
        'bkey));': '    if (tid == 0) *w = pack_best(1.f, 0);'},
}


def floor_calls(smoke):
    """Part 11a-floor's inputs, standing in for ``soft_nms_calls`` without
    a model: ``chip_smoke.soft_nms_large_k_case`` cut to each call's K,
    with its steps and method (an empty step reads no score)."""
    import numpy as np
    sboxes, scores = smoke.soft_nms_large_k_case(np, torch)
    return {name: (sboxes[:, :k].contiguous(), scores[:, :k].contiguous(),
                   100, 0.5, 0.5, 1e-3, method)
            for name, k, method in (
                ('frcnn K=2000 linear', 2000, 'linear'),
                ('cornernet K=10000 gaussian', 10000, 'gaussian'),
                ('large K=12000 linear', 12000, 'linear'))}


def probe_soft_nms_floor(smoke, report, calls=None):
    """Part 11a's latency floor: ``steps`` empty steps (the pass's decay
    and the early exit taken out: shuffle trees, record writes and the
    barrier only) at each call's K (``calls``, by default
    ``floor_calls``), an image a block and a cluster of 2, 4 and 8
    blocks, by graph replays; from an edited copy of ``csrc/soft_nms.cu``
    (``chip_smoke.SOFT_NMS_FLOOR_EDITS``), on no path. Not measured where
    the edits do not fit the source."""
    calls = calls or floor_calls(smoke)
    out = report.setdefault('11a', {})
    variants = {'': {}}
    variants.update({f' {v}': e for v, alts in SOFT_NMS_PARTS.items()
                     for e in [fitting_edits('soft_nms', alts)] if e})
    for threads in ('', ' threads_1024'):
        if threads and threads not in variants:
            continue
        variants.update({f'{threads} {part}': {**variants[threads], **e}
                         for part, e in SOFT_NMS_FLOOR_PARTS.items()})
    for variant, edits in variants.items():
        handle = smoke.start_soft_nms_floor_build(
            {**edits, **smoke.SOFT_NMS_FLOOR_EDITS},
            'floor' + variant.replace(' ', '_'))
        floor = out.setdefault('floor' + variant, {})
        if handle is None:
            print(f'probe 11a floor{variant}: not measured (the edits do not '
                  f'fit this csrc/soft_nms.cu)', flush=True)
            continue
        lib = smoke.soft_nms_floor_lib(handle)
        for name, args in calls.items():
            steps = args[2]
            row = {cs: smoke.soft_nms_floor_ms(torch, lib, args, cs)
                   for cs in (1, 2, 4, 8)}
            # one step: the launch, the compaction and the loads
            one = (args[0], args[1], 1) + tuple(args[3:])
            row['one step, one block'] = smoke.soft_nms_floor_ms(torch, lib,
                                                                 one, 1)
            floor[name] = row
            print(f'probe 11a floor{variant} {name}: {steps} empty steps, '
                  f'graph ms by cluster size ' + ', '.join(
                      f'{cs}: {fmt(ms)}' + (f' ({1e3 * ms / steps:.3f} us a '
                                            f'step)' if ms else '')
                      for cs, ms in row.items()), flush=True)


def winner_overlaps(args, idx):
    """The mean, over the steps that select, of the candidates live at load
    (less those selected before) whose boxes overlap the step's winner's:
    the decays a step can make (drops by min_score not taken off)."""
    sboxes, scores = args[0][0], args[1][0]
    steps = int((idx[0] > 0).sum()) or 1
    win = sboxes[idx[0, :steps]]
    iw = (torch.minimum(win[:, None, 2], sboxes[None, :, 2]) -
          torch.maximum(win[:, None, 0], sboxes[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(win[:, None, 3], sboxes[None, :, 3]) -
          torch.maximum(win[:, None, 1], sboxes[None, :, 1])).clamp(min=0)
    live = (scores > float('-inf'))[None].expand(steps, -1).clone()
    for s in range(steps):
        live[s:, idx[0, s]] = False
    return float(((iw * ih > 0) & live).sum(1).float().mean())


def probe_soft_nms(smoke, report):
    """Part 11a, the soft-NMS scan, at ``soft_nms_calls``: the call by
    graph replays and events, the kernel by the profiler, the live
    candidates an image, the step from which nothing is live (every
    candidate consumed or dropped), the plan (cluster size, slice, a
    thread's candidates) where the wrapper has one, selections and scores
    against plain (linear bit-exact, gaussian 1e-6 relative), the plain
    version's time, the bound (``chip_smoke.soft_nms_cost``), and the
    latency floor (``probe_soft_nms_floor``)."""
    from erd_tpu_torch.ops import cuda_build, soft_nms, soft_nms_plain
    nms_module = importlib.import_module('erd_tpu_torch.ops.nms')
    calls = soft_nms_calls(smoke)
    out = report.setdefault('11a', {})
    # the variants of this design (a parent's wrapper has no launch plan)
    redesign = hasattr(nms_module, 'soft_nms_launch')
    variants = {v: (edited_lib('soft_nms', v, e) if e and redesign else None)
                for v, alts in SOFT_NMS_PARTS.items()
                for e in [fitting_edits('soft_nms', alts)]}
    for name, args in calls.items():
        steps, method = args[2], args[6]
        gi, gs = soft_nms(*args)
        torch.cuda.synchronize()
        wi, ws = soft_nms_plain(*args)
        live, exhausted = smoke.soft_nms_stats(torch, args, gs)
        on = ws > float('-inf')
        rel = float(((gs - ws).abs() / ws.abs())[on].max()) \
            if bool(on.any()) else 0.0
        plan = None
        if hasattr(nms_module, 'soft_nms_plan'):
            threads, capacity = nms_module.soft_nms_limits(
                cuda_build.load('soft_nms'), args[1].device)
            plan = nms_module.soft_nms_plan(args[1].shape[1], capacity,
                                            threads) + (threads,)
        graph = smoke.graph_ms(torch, lambda: soft_nms(*args), 20)
        events = smoke.events_ms(torch, lambda: soft_nms(*args), 20)
        prof = device_ops_ms(lambda: soft_nms(*args),
                             {'kernel': 'soft_nms'}, 10)['kernel']
        plain = smoke.events_ms(torch, lambda: soft_nms_plain(*args), 2)
        bms, by = smoke.bound_of(*smoke.soft_nms_cost(args, live, exhausted))
        overlaps = winner_overlaps(args, gi)
        out[name] = dict(
            k=args[1].shape[1], steps=steps, method=method, live=live,
            overlapping_the_winner=overlaps,
            nothing_live_from=exhausted, plan=plan, graph_ms=graph,
            events_ms=events, kernel_ms=prof, plain_ms=plain, bound_ms=bms,
            bound_by=by, selections_equal=bool(torch.equal(gi, wi)),
            scores_equal=bool(torch.equal(gs, ws)), max_rel_err=rel,
            kept=int((gs >= args[5]).sum()))
        print(f'probe 11a {name}: live {live}, nothing live from step '
              f'{exhausted}, {overlaps:.1f} candidates overlap a step\'s '
              f'winner, plan {plan}: graph {graph:.4f} ms, events '
              f'{events:.4f}, kernel {fmt(prof)} (profiler); plain '
              f'{plain:.3f}; bound {bms:.6f} ({by}); selections equal '
              f'{torch.equal(gi, wi)}, scores bit-equal {torch.equal(gs, ws)}'
              f', max rel err {rel:.2e}', flush=True)
        ok = torch.equal(gi, wi) and (torch.equal(gs, ws) if method ==
                                      'linear' else rel <= 1e-6)
        if not ok:
            raise RuntimeError(f'probe 11a {name}: the kernel disagrees with '
                               f'plain')
        if redesign:  # the redesign with each cluster size forced
            lib = cuda_build.load('soft_nms')
            by_cluster = {}
            for cs in (1, 2, 4, 8):
                forced = smoke.soft_nms_forced_plan(lib, args, cs)
                if forced is None:
                    by_cluster[cs] = None
                    continue
                vi, vs = nms_module.soft_nms_launch(lib, *args, plan=forced)
                if not (torch.equal(vi, gi) and torch.equal(vs, gs)):
                    raise RuntimeError(f'probe 11a {name}: a cluster of {cs}'
                                       f' differs')
                by_cluster[cs] = smoke.graph_ms(
                    torch, lambda: nms_module.soft_nms_launch(
                        lib, *args, plan=forced), 20)
            out[name]['by_cluster'] = by_cluster
            print(f'probe 11a {name}: graph ms by cluster size (forced) ' +
                  ', '.join(f'{cs}: {fmt(ms)}'
                            for cs, ms in by_cluster.items()), flush=True)
        for variant, lib in variants.items():
            if lib is None:
                out[name][variant] = None
                continue
            vi, vs = nms_module.soft_nms_launch(lib, *args)
            same = bool(torch.equal(vi, gi) and torch.equal(vs, gs))
            ms = smoke.graph_ms(torch, lambda: nms_module.soft_nms_launch(
                lib, *args), 20)
            out[name][variant] = dict(graph_ms=ms, equal=same)
            print(f'probe 11a {name} {variant}: graph {ms:.4f} ms, equal to '
                  f'the kernel {same}', flush=True)
            if not same:
                raise RuntimeError(f'probe 11a {name} {variant}: differs')
        del gi, gs, wi, ws
    probe_soft_nms_floor(smoke, report, calls)


# part 15's device operations: the kernel, the zero-fills, and every other
# operation (the scalars' torch ops, the stack and cat of their inputs)
CORNER_TARGET_OPS = {'kernel': 'corner_targets_kernel', 'fill': 'fill'}


def corner_targets_call(smoke):
    """The arguments of ``render_corner_targets`` at one bs-6, 768x1024
    CornerNet step: the detector's ``targets`` on the train cell's first
    batch (``chip_smoke.mask_train_loader``), on the card."""
    import numpy as np

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.engine import batch_to
    cn = importlib.import_module('erd_tpu_torch.models.detectors.cornernet')
    det = build_detector(Config.fromfile(smoke.CORNERNET_CONFIG).model)
    batch = batch_to(next(iter(smoke.mask_train_loader(
        np, torch, 'cornernet', 1, 61).epoch(0))), smoke.DEV)
    h, w = batch['images'].shape[1:3]
    calls = []
    undo = smoke.capture(cn, 'render_corner_targets', calls)
    try:
        det.targets(batch['gt'], (h, w), (h // 4, w // 4))
    finally:
        undo()
    return calls[0]


def device_op_split(fn, names, n=10):
    """{key: (device ms a call, launches a call)} of the operations whose
    profiler name holds ``names[key]`` (case-insensitive), and 'other' for
    the rest."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {key: [0.0, 0] for key in list(names) + ['other']}
    for ev in prof.key_averages():
        us = getattr(ev, 'device_time_total', None) or \
            getattr(ev, 'cuda_time_total', 0.0)
        if not us:
            continue
        key = next((k for k, t in names.items()
                    if t.lower() in ev.key.lower()), 'other')
        out[key][0] += us / n / 1e3
        out[key][1] += ev.count / n
    return {k: tuple(v) for k, v in out.items()}


def probe_corner_targets(smoke, report):
    """Part 15, CornerNet's corner targets, at one bs-6 step's call
    (``corner_targets_call``): the call by graph replays and events (the
    eager call), its device operations apart by the profiler
    (``CORNER_TARGET_OPS``: the kernel, the zero-fills, the rest), the
    valid gts and gaussian cells, the plain version's time, the bound
    (``chip_smoke.corner_targets_cost``), and the outputs against plain
    (heat within 1e-6, the exact-1 peaks, offsets, weights and corner
    pixels equal)."""
    from erd_tpu_torch.ops.gaussian import (corner_scalars,
                                            render_corner_targets,
                                            render_corner_targets_plain)
    args = corner_targets_call(smoke)
    boxes, labels, mask, feat_hw, num_classes = args[:5]
    got = render_corner_targets(*args)
    torch.cuda.synchronize()
    sc = corner_scalars(*args)
    want = render_corner_targets_plain(sc, feat_hw, num_classes)
    err, peaks, equal = 0.0, [], True
    for c in ('tl', 'br'):
        err = max(err, float((got[f'{c}_heat'] - want[f'{c}_heat']).abs()
                             .max()))
        peaks.append((int((got[f'{c}_heat'] == 1).sum()),
                      int((want[f'{c}_heat'] == 1).sum())))
        equal &= all(torch.equal(got[f'{c}_{k}'], want[f'{c}_{k}'])
                     for k in ('off', 'w'))
        equal &= torch.equal(got[f'{c}_xy'], torch.stack(
            [sc[f'{c}_x'], sc[f'{c}_y']], -1))
    del got, want
    nbytes, _, cells = smoke.corner_targets_cost(torch, args)
    bms, by = smoke.bound_of(*smoke.corner_targets_cost(torch, args)[:2])
    graph = smoke.graph_ms(torch, lambda: render_corner_targets(*args), 10)
    events = smoke.events_ms(torch, lambda: render_corner_targets(*args), 10)
    ops = device_op_split(lambda: render_corner_targets(*args),
                          CORNER_TARGET_OPS)
    plain = smoke.events_ms(torch, lambda: render_corner_targets_plain(
        corner_scalars(*args), feat_hw, num_classes), 2)
    report['15'] = dict(
        b=int(mask.shape[0]), g=int(mask.shape[1]), valid=int(mask.sum()),
        classes=num_classes, feat_hw=list(feat_hw), cells=cells,
        graph_ms=graph, events_ms=events, ops=ops, plain_ms=plain,
        bound_ms=bms, bound_by=by, bound_bytes=nbytes, heat_max_abs_err=err,
        peaks=peaks, others_equal=bool(equal))
    print(f'probe 15: B={mask.shape[0]} G={mask.shape[1]} '
          f'({int(mask.sum())} valid), {num_classes} classes at '
          f'{tuple(feat_hw)}, {cells:.0f} gaussian cells: graph {graph:.4f} '
          f'ms, events (eager call) {events:.4f}; profiler (ms, launches a '
          f'call) ' + ', '.join(f'{k} {v[0]:.4f} x{v[1]:.0f}'
                                for k, v in ops.items()) +
          f'; plain {plain:.3f}; bound {bms:.4f} ({by}, {nbytes} bytes); heat '
          f'max_abs_err {err:.3e}, peaks {peaks}, offsets, weights and '
          f'corner pixels equal {equal}', flush=True)
    if not (err <= 1e-6 and equal and all(a == b > 0 for a, b in peaks)):
        raise RuntimeError('probe 15: the kernel disagrees with plain')


@functools.lru_cache(maxsize=None)
def mask_step_calls(smoke, kind):
    """The captured calls of one bs-16, 800x1344 training step of ``kind``
    (``chip_smoke.mask_train_step_calls``): the mask targets, and for
    PointRend the point-sample calls too. Made once for parts 13a and
    14."""
    import numpy as np
    names = ('crop_resize_mask',) + (
        ('point_sample',) if kind == 'point_rend' else ())
    got = smoke.mask_train_step_calls(np, torch, kind, names)
    return {n: [tuple(a.detach() if torch.is_tensor(a) else a for a in args)
                for args in calls] for n, calls in got.items()}


# PointRend's four point-sample calls of a training step, in the order
# of its loss (erd_tpu_torch/models/detectors/point_rend.py)
POINT_TRAIN_CALLS = ('uncertainty', 'coarse', 'fine', 'targets')


def point_forward_calls(smoke):
    """[(name, maps, points)]: the four point-sample calls of one bs-16
    PointRend training step (t1-t4, ``POINT_TRAIN_CALLS``), then the two
    call shapes of one 800x1333 PointRend request (its first coarse and
    first fine call), as ``chip_smoke.phase_mask_kernels`` takes them."""
    import numpy as np
    train = mask_step_calls(smoke, 'point_rend')['point_sample']
    if len(train) != 4:
        raise RuntimeError(f'probe 13a: {len(train)} point_sample calls in '
                           f'a PointRend step, expected 4')
    out = [(f'train {name}', args[0], args[1])
           for name, args in zip(POINT_TRAIN_CALLS, train)]
    pr_module = importlib.import_module(
        'erd_tpu_torch.models.detectors.point_rend')
    det, net, batch = smoke.mask_net(np, torch, 'point_rend')
    calls = []
    undo = smoke.capture(pr_module, 'point_sample', calls)
    try:
        with torch.no_grad():
            det.predict(net, batch)
    finally:
        undo()
    torch.cuda.synchronize()
    for form, dtype in (('coarse', torch.float32), ('fine', torch.bfloat16)):
        maps, pts = next(a[:2] for a in calls if a[0].dtype == dtype)
        out.append((f'serve {form}', maps.detach(), pts.detach()))
    del det, net, batch, calls
    torch.cuda.empty_cache()
    return out


def point_lanes(sp, maps, k):
    """(layout, active lanes a warp) of the kernel for ``maps`` sampled at
    k points a map: the plan's where the wrapper has one
    (``point_sample_plan``), else the parent design's warp a point, a lane
    a channel (c / ceil(c / 32))."""
    c = maps.shape[1]
    plan = getattr(sp, 'point_sample_plan', None)
    if plan is None:
        return 'warp a point', c / -(-c // 32)
    p = plan(tuple(maps.shape), maps.stride(), maps.dtype, k,
             maps.data_ptr())
    return p.layout, p.active_lanes


def point_layouts(sp, maps, k):
    """{name: plan} of the forward's layouts that take ``maps`` at k points
    a map (the redesign's wrapper only): the plan's own, the staged layout
    at 4, 8 and 16 maps a block where it is staged, the unit-stride layout
    where the channels allow it, and the general layout."""
    if not hasattr(sp, 'point_sample_plan'):
        return {}
    plan = sp.point_sample_plan(tuple(maps.shape), maps.stride(), maps.dtype,
                                k, maps.data_ptr())
    out = {f'plan ({plan.layout})': plan}
    if plan.layout == 'staged':
        for g in (4, 8, 16):
            if g != plan.maps_per_block and \
                    g * plan_bytes(sp, maps, k) <= sp.STAGE_BYTES:
                out[f'staged {g} maps'] = plan._replace(maps_per_block=g)
    c = maps.shape[1]
    sn, sc, sy, sx = maps.stride()
    vec = 16 // maps.element_size()
    if plan.layout != 'unit' and sc == 1 and c % vec == 0 and \
            maps.data_ptr() % 16 == 0 and \
            all(v % vec == 0 for v in (sn, sy, sx)):
        out['unit'] = sp.PointSamplePlan('unit')
    if plan.layout != 'general':
        out['general'] = sp.PointSamplePlan('general')
    return out


def plan_bytes(sp, maps, k):
    """The staged layout's shared memory a map (the map, and its points'
    records where C > 1)."""
    _, c, h, w = maps.shape
    return -(-c * h * w * maps.element_size() // 16) * 16 + (
        k * sp.POINT_RECORD_BYTES if c > 1 else 0)


def host_profile(fn, n=200, top=6):
    """(host us a call, [(function, us a call)]): the host's time to issue
    n calls back to back (no synchronisation between them), and the
    functions that take the most of it by cProfile (its own time, the
    profiler's overhead included)."""
    import cProfile
    import pstats
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    return host, [(f'{f[2]} ({os.path.basename(f[0])}:{f[1]})',
                   v[2] / n * 1e6) for f, v in rows]


# edits of csrc/point_sample.cu for part 13a: the unit-stride layout with
# 1 or 4 points in flight a thread instead of 2, and the staged layout at
# 512 threads a block instead of 256 (on no path)
POINT_FORWARD_PARTS = {
    'unit_points_1': ({'constexpr int kUnitPoints = 2;':
                       'constexpr int kUnitPoints = 1;'},),
    'unit_points_4': ({'constexpr int kUnitPoints = 2;':
                       'constexpr int kUnitPoints = 4;'},),
    'staged_threads_512': ({'constexpr int kStagedThreads = 256;':
                            'constexpr int kStagedThreads = 512;'},),
}


def probe_point_forward(smoke, report):
    """Part 13a, the point-sample forward, at the four calls of one bs-16
    PointRend step and the two call shapes of one request
    (``point_forward_calls``): the call by graph replays and by events
    (the eager call), the plain version's time, F.grid_sample on the
    widened float32 map (``chip_smoke.grid_sample_points``), the bytes
    bound as ``chip_smoke.phase_mask_kernels`` counts it, the maps'
    strides, the layout and its active lanes a warp, the output against
    plain (torch.equal); each layout that takes the call
    (``point_layouts``) and the ``POINT_FORWARD_PARTS`` variants of its
    own layout by graph replays; at the serving calls the host's time a
    call and its largest parts (``host_profile``)."""
    sp = importlib.import_module('erd_tpu_torch.ops.sampling')
    variants = {v: variant_lib('point_sample', f'forward_{v}', alts)
                for v, alts in POINT_FORWARD_PARTS.items()}
    rows = []
    for name, maps, pts in point_forward_calls(smoke):
        n, k = pts.shape[:2]
        c = maps.shape[1]

        def call():
            return sp.point_sample(maps, pts)
        got = call()
        torch.cuda.synchronize()
        want = sp.point_sample_plain(maps, pts)
        equal = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        del got, want
        torch.cuda.empty_cache()
        reps = 3 if n * k * c * 4 > 256 << 20 else 10
        graph = smoke.graph_ms(torch, call, reps)
        events = smoke.events_ms(torch, call, reps)
        plain = smoke.events_ms(torch, lambda: sp.point_sample_plain(
            maps, pts), 2)
        torch.cuda.empty_cache()
        maps32 = maps.float()
        library = smoke.graph_ms(torch, lambda: smoke.grid_sample_points(
            torch, maps32, pts), reps)
        del maps32
        torch.cuda.empty_cache()
        _, _, _, touched = smoke.point_sample_stats(torch, maps, pts)
        nbytes = touched * c * maps.element_size() + n * k * c * 4 + \
            n * k * 8
        bms, by = smoke.bound_of(nbytes, n * k * c * 11.0)
        layout, lanes = point_lanes(sp, maps, k)
        forced = {}
        for lname, plan in point_layouts(sp, maps, k).items():
            same = bool(torch.equal(sp.point_sample_launch(maps, pts, plan),
                                    sp.point_sample_plain(maps, pts)))
            torch.cuda.empty_cache()
            forced[lname] = dict(graph_ms=smoke.graph_ms(
                torch, lambda: sp.point_sample_launch(maps, pts, plan), reps),
                equal=same)
            if not same:
                raise RuntimeError(f'probe 13a {name}: layout {lname} '
                                   f'differs from plain')
        for v, lib in variants.items():
            if lib is None or v.split('_')[0] != layout:
                continue
            same = with_lib('point_sample', lib, lambda: bool(torch.equal(
                call(), sp.point_sample_plain(maps, pts))))
            torch.cuda.empty_cache()
            forced[v] = dict(graph_ms=with_lib(
                'point_sample', lib, lambda: smoke.graph_ms(torch, call,
                                                             reps)),
                equal=same)
        host, top = host_profile(call) if name.startswith('serve') else \
            (None, [])
        rows.append(dict(call=name, maps=list(maps.shape),
                         dtype=str(maps.dtype), strides=list(maps.stride()),
                         points=list(pts.shape), graph_ms=graph,
                         events_ms=events, plain_ms=plain, library_ms=library,
                         bound_ms=bms, bound_by=by, bytes=nbytes,
                         layout=layout, active_lanes=lanes, equal=equal,
                         max_abs_err=err, layouts=forced, host_us=host,
                         host_top=top))
        print(f'probe 13a {name}: maps {tuple(maps.shape)} {maps.dtype} '
              f'strides {maps.stride()}, points {tuple(pts.shape)}: graph '
              f'{graph:.4f} ms, events (eager call) {events:.4f}, plain '
              f'{plain:.3f}, F.grid_sample (float32 map) {library:.4f}, '
              f'bound {bms:.5f} ({by}, {nbytes / 1e6:.1f} MB, '
              f'{graph / bms:.2f}x); layout {layout}, {lanes:.1f} active '
              f'lanes a warp; equal to plain {equal} (max_abs_err '
              f'{err:.3e}); layouts (graph ms, equal): ' + ', '.join(
                  f'{v} {fmt(t["graph_ms"])} {t["equal"]}'
                  for v, t in forced.items()) +
              ('' if host is None else f'; host {host:.1f} us a call, '
               f'cProfile (us a call): ' + ', '.join(
                   f'{f} {t:.1f}' for f, t in top)), flush=True)
        if not equal:
            raise RuntimeError(f'probe 13a {name}: the kernel differs from '
                               f'plain')
    report['13a'] = dict(calls=rows, train_step_graph_ms=sum(
        r['graph_ms'] for r in rows if r['call'].startswith('train')))
    torch.cuda.empty_cache()


# edits of csrc/mask_target.cu for part 14: the redesign with a RoI a
# warp, or about 320 items (4 cells each) a warp instead of 160, with the
# out size read at run time at 28 and 14 too, without its crop reads (the
# corners' indices summed instead), with the crop bytes converted through
# their float bits (2^23 + v, less 2^23), and
# without its store (the sums kept live by a test that never holds); on
# no path
MASK_TARGET_PARTS = {
    'a_roi_a_warp': ({'constexpr int kItemsPerWarp = 160;':
                      'constexpr int kItemsPerWarp = 1;'},),
    'items_320': ({'constexpr int kItemsPerWarp = 160;':
                   'constexpr int kItemsPerWarp = 320;'},),
    'no_crop_loads': ({
        'byte_to_float(__ldg(m + y0 + x0))': 'byte_to_float(y0 + x0)',
        'byte_to_float(__ldg(m + y0 + x1))':
        'byte_to_float(y0 + x1 + (m == nullptr))',
        'byte_to_float(__ldg(m + y1 + x0))': 'byte_to_float(y1 + x0)',
        'byte_to_float(__ldg(m + y1 + x1))': 'byte_to_float(y1 + x1)'},),
    'runtime_size': ({
        'size == 14   ? crop_resize_mask_kernel<4, 14>':
        'size == -1   ? crop_resize_mask_kernel<4, 14>',
        ': size == 28 ? crop_resize_mask_kernel<4, 28>':
        ': size == -1 ? crop_resize_mask_kernel<4, 28>'},),
    'unroll_1': ({'#pragma unroll 2\n  for (int t = lane; t < n_roi * per_roi':
                  '#pragma unroll 1\n  for (int t = lane; t < n_roi * per_roi'},),
    'unroll_4': ({'#pragma unroll 2\n  for (int t = lane; t < n_roi * per_roi':
                  '#pragma unroll 4\n  for (int t = lane; t < n_roi * per_roi'},),
    'occupancy_8_blocks': ({'__launch_bounds__(kWarps * 32)':
                            '__launch_bounds__(kWarps * 32, 8)'},),
    'bits_conversion': ({
        'return static_cast<float>(v);':
        'return __fsub_rn(__uint_as_float(0x4b000000u | v), 8388608.f);'},),
    'no_store': ({
        '      *reinterpret_cast<float4*>(dst + t * 4) =\n'
        '          make_float4(res[0], res[1], res[2], res[3]);':
        '      if (res[0] + res[1] + res[2] + res[3] == 12345.f)\n'
        '        dst[t] = 1.f;'},),
}


def probe_mask_targets(smoke, report):
    """Part 14, the mask targets, at the call of one bs-16 Mask R-CNN step
    (28 x 28) and one PointRend step (14 x 14): the call by graph replays
    and by events (the eager call), the plain version's time, the
    F.grid_sample formulation (``chip_smoke.crop_resize_library``), the
    bound as ``chip_smoke.phase_mask_train_kernels`` counts it, the
    targets against plain (torch.equal), the ``MASK_TARGET_PARTS``
    variants by graph replays, and the host's time a call and its largest
    parts (``host_profile``)."""
    masks_module = importlib.import_module('erd_tpu_torch.data.masks')
    variants = {v: variant_lib('mask_target', f'mask_{v}', alts)
                for v, alts in MASK_TARGET_PARTS.items()}
    rows = []
    for kind in ('mask_rcnn', 'point_rend'):
        args = mask_step_calls(smoke, kind)['crop_resize_mask'][0]
        masks, boxes, idx, rois, size = args

        def call():
            return masks_module.crop_resize_mask(*args)
        got = call()
        torch.cuda.synchronize()
        want = masks_module.crop_resize_mask_plain(*args)
        equal = bool(torch.equal(got, want))
        del got
        graph = smoke.graph_ms(torch, call, 20)
        events = smoke.events_ms(torch, call, 20)
        plain = smoke.events_ms(torch, lambda: masks_module.
                                crop_resize_mask_plain(*args), 3)
        lib, _ = smoke.crop_resize_library(torch, *args)
        library = smoke.graph_ms(torch, lib, 20)
        nbytes = masks.numel() + boxes.numel() * 4 + idx.numel() * 8 + \
            rois.numel() * 4 + want.numel() * 4
        bms, by = smoke.bound_of(nbytes, want.numel() * 30.0)
        parts = {}
        for v, lib in variants.items():
            if lib is None:
                parts[v] = None
                continue
            same = with_lib('mask_target', lib, lambda: bool(torch.equal(
                call(), want)))
            if v in ('a_roi_a_warp', 'items_320', 'runtime_size',
                     'bits_conversion') and not same:
                raise RuntimeError(f'probe 14 {kind} {v}: differs from '
                                   f'plain')
            parts[v] = dict(graph_ms=with_lib('mask_target', lib, lambda:
                                              smoke.graph_ms(torch, call, 20)),
                            equal=same)
        host, top = host_profile(call)
        rows.append(dict(config=kind, out=list(want.shape),
                         gt_idx_dtype=str(idx.dtype), graph_ms=graph,
                         events_ms=events, plain_ms=plain, library_ms=library,
                         bound_ms=bms, bound_by=by, bytes=nbytes,
                         equal=equal, parts=parts, host_us=host,
                         host_top=top))
        print(f'probe 14 {kind}: targets {tuple(want.shape)} (gt_idx '
              f'{idx.dtype}, crops {tuple(masks.shape)}): graph {graph:.4f} '
              f'ms, events (eager call) {events:.4f}, plain {plain:.3f}, '
              f'F.grid_sample formulation {library:.4f}, bound {bms:.5f} '
              f'({by}, {nbytes} bytes, {graph / bms:.2f}x); equal to plain '
              f'{equal}; ' + ', '.join(
                  f'{v} ' + ('not measured' if t is None else
                             f'{t["graph_ms"]:.4f} (equal {t["equal"]})')
                  for v, t in parts.items()) +
              f'; host {host:.1f} us a call, cProfile (us a call): ' +
              ', '.join(f'{f} {t:.1f}' for f, t in top), flush=True)
        del want
        if not equal:
            raise RuntimeError(f'probe 14 {kind}: the kernel differs from '
                               f'plain')
    report['14'] = dict(calls=rows)
    torch.cuda.empty_cache()


def eager_ms(smoke, fn, n=20, reps=5):
    """The median of ``reps`` event timings of n eager calls (a call's
    time on the card's timeline; where the host is slower than the
    kernel, the host's time a call). The host is shared, so one timing
    varies by tens of per cent."""
    times = sorted(smoke.events_ms(torch, fn, n) for _ in range(reps))
    return times[reps // 2]


def graph_launches(fn):
    """The kernel, memset and memcpy nodes of a CUDA graph of one call of
    ``fn`` (cudaGraphDebugDotPrint's dump), or None where the dump names
    none: the launches a call makes, none lost (the profiler drops short
    kernels' records)."""
    import re
    import tempfile
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # dumped before exec
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'graph.dot')
        graph.debug_dump(path)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            dot = f.read()
    del graph
    count = len(re.findall(r'label="\{?\s*(KERNEL|MEMSET|MEMCPY)', dot))
    return count or None


def decode_serving_calls(smoke):
    """[(name, head reg maps, decode args)]: one 800x1333 request of GFL
    R50 (the ERD config, ``chip_smoke.phase_serve``'s model, class bias
    zeroed) and of GFL R101-DCN (``chip_smoke.dcn_net``): the head's five
    distribution maps as ``forward_raw`` returns them, and the arguments
    ``gfl_predict`` hands ``integral_decode`` (a flat (1, N, 68) float32
    tensor or the level maps, as the tree's path has it)."""
    import numpy as np

    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.data import DetPipeline
    head = importlib.import_module('erd_tpu_torch.models.heads.gfl_head')
    img = smoke.request_images(np)[-1]
    out = []
    for name in ('gfl serve', 'gfl_r101_dcn serve'):
        if name == 'gfl serve':
            det, net, _ = init_detector(smoke.ERD_CONFIG, device=smoke.DEV)
            with torch.no_grad():
                net.bbox_head.gfl_cls.bias.zero_()
        else:
            det, net = smoke.dcn_net(torch, smoke.DCN_CONFIGS['gfl_r101_dcn'],
                                     'gfl_r101_dcn')
        req = smoke.ServedRequest(np, torch, DetPipeline(), 3, img)
        with torch.no_grad():
            ctx = det.anchor_context(req.images.shape[1:3])
            cls, reg = det.forward_raw(net, req.images)
            calls = []
            undo = smoke.capture(head, 'integral_decode', calls)
            try:
                det.postprocess(ctx, cls, reg, req.meta_dev)
            finally:
                undo()
        torch.cuda.synchronize()
        if len(calls) != 1:
            raise RuntimeError(f'probe 2 {name}: {len(calls)} decode calls')
        out.append((name, reg, calls[0]))
        del det, net, cls
    return out


def decode_cost(reg, rows, batch):
    """(bytes, operations) of a decode as ``chip_smoke.phase_kernels``
    counts them: each distinct row's logits, centre and stride read once
    an image, the rows and img_shape read, the boxes written; 121
    operations a side."""
    k = rows.shape[1]
    levels = reg if isinstance(reg, (list, tuple)) else [reg]
    es = levels[0].element_size()
    uniq = sum(int(torch.unique(rows[i]).numel()) for i in range(batch))
    nbytes = uniq * (68 * es + 8 + 4) + batch * k * (8 + 16) + batch * 8
    return nbytes, batch * k * 4 * 121.0


# edits of csrc/integral_decode.cu for part 2: blocks of 16 or 64
# candidates instead of 32 (on no path)
DECODE_PARTS = {
    'cand_16': ({'constexpr int kCand = 32;': 'constexpr int kCand = 16;'},),
    'cand_64': ({'constexpr int kCand = 32;': 'constexpr int kCand = 64;'},),
}


def probe_decode(smoke, report):
    """Part 2, the GFL integral decode (``integral_decode``), at its call
    shapes on the main paths: one 800x1333 request of GFL R50 and of GFL
    R101-DCN (1 x 5000 candidate rows of the five level maps) and ERD's
    two training calls (``chip_smoke.train_case`` at bs 16: the first
    1024 and 4481 ERS rows of the flat (16, 22400, 68) teacher map, unit
    stride, no clip). At each: the call by graph replays and by events
    (the eager call), the plain version's time, the bound as
    ``chip_smoke.phase_kernels`` counts it, the largest error against
    plain beside the gate (1e-4 * stride + 1e-5 * |box| px), the
    ``DECODE_PARTS`` variants by graph replays; events are the median of
    five timings (``eager_ms``); at the serving calls the level maps'
    dtypes and strides, the launches that
    feed the decode in the parent's path (``.float()`` of each map and
    ``flatten_levels``) timed apart by graph replays, the call together
    with them, the launches of each (``graph_launches``), and the host's
    time a call (``host_profile``)."""
    import numpy as np

    from erd_tpu_torch.models.heads.gfl_head import (AnchorContext,
                                                     flatten_levels)
    from erd_tpu_torch.ops import integral_decode, integral_decode_plain
    from erd_tpu_torch.ops.ers_select import ers_select
    rows = []
    variants = {v: variant_lib('integral_decode', f'decode_{v}', alts)
                for v, alts in DECODE_PARTS.items()}

    def measure(name, args, feed=None):
        reg, rws, centers, strides, shape = args[:5]

        def call():
            return integral_decode(*args)

        def plain():
            flat = flatten_levels([r.float() for r in reg]) \
                if isinstance(reg, (list, tuple)) else reg
            return integral_decode_plain(flat, *args[1:])
        got = call()
        torch.cuda.synchronize()
        want = plain()
        err = (got - want).abs()
        stride = strides[rws].unsqueeze(-1)
        tol = 1e-4 * stride + 1e-5 * want.abs()
        ratio = float((err / tol).max())
        b = rws.shape[0]
        nbytes, ops = decode_cost(reg, rws, b)
        bms, by = smoke.bound_of(nbytes, ops)
        row = dict(call=name, rows=list(rws.shape),
                   graph_ms=smoke.graph_ms(torch, call, 20),
                   events_ms=eager_ms(smoke, call),
                   plain_ms=smoke.events_ms(torch, plain, 3), bound_ms=bms,
                   bound_by=by, bytes=nbytes,
                   max_abs_err=float(err.max()),
                   err_over_tolerance=ratio, library_ms=None)
        row['variants'] = {}
        for v, lib in variants.items():
            if lib is None:
                row['variants'][v] = None
                continue
            err_v = with_lib('integral_decode', lib, lambda: float(
                (call() - want).abs().max()))
            row['variants'][v] = dict(graph_ms=with_lib(
                'integral_decode', lib, lambda: smoke.graph_ms(
                    torch, call, 20)), max_abs_err=err_v)
        if isinstance(reg, (list, tuple)):
            row['maps'] = [dict(shape=list(r.shape), dtype=str(r.dtype),
                                strides=list(r.stride())) for r in reg]
        else:
            row['maps'] = [dict(shape=list(reg.shape), dtype=str(reg.dtype),
                                strides=list(reg.stride()))]
        if feed is not None:
            parent_feed = lambda: flatten_levels(  # noqa: E731
                [r.float() for r in feed])
            row['feed_graph_ms'] = smoke.graph_ms(torch, parent_feed, 20)
            row['feed_launches'] = graph_launches(parent_feed)
            row['feed_maps'] = [dict(shape=list(r.shape), dtype=str(r.dtype),
                                     strides=list(r.stride()))
                                for r in feed]
            path = call if isinstance(reg, (list, tuple)) else \
                (lambda: integral_decode(parent_feed(), *args[1:]))
            row['path'] = 'levels in place' if isinstance(
                reg, (list, tuple)) else 'casts + cat + decode'
            row['path_graph_ms'] = smoke.graph_ms(torch, path, 20)
            row['path_events_ms'] = eager_ms(smoke, path)
            row['call_launches'] = graph_launches(call)
            flat = parent_feed()
            row['flat_call_graph_ms'] = smoke.graph_ms(
                torch, lambda: integral_decode(flat, *args[1:]), 20)
            del flat
            row['host_us'], row['host_top'] = host_profile(call)
        rows.append(row)
        print(f'probe 2 {name}: rows {tuple(rws.shape)}, maps ' + ', '.join(
            f'{tuple(m["shape"])} {m["dtype"]} {tuple(m["strides"])}'
            for m in row['maps']) + f': graph {row["graph_ms"]:.4f} ms, '
            f'events (eager call) {row["events_ms"]:.4f}, plain '
            f'{row["plain_ms"]:.3f}, bound {bms:.5f} ({by}, {nbytes} bytes, '
            f'{row["graph_ms"] / bms:.1f}x); max_abs_err '
            f'{row["max_abs_err"]:.3e} px ({ratio:.3f} of the gate); ' +
            ', '.join(f'{v} ' + ('not measured' if t is None else
                                 f'{t["graph_ms"]:.4f} (err '
                                 f'{t["max_abs_err"]:.2e})')
                      for v, t in row['variants'].items()) + (
                '' if feed is None else
                f'; path ({row["path"]}) graph {row["path_graph_ms"]:.4f} ms, '
                f'events {row["path_events_ms"]:.4f}; the parent\'s feed '
                f'(.float() x5 + flatten_levels) graph '
                f'{row["feed_graph_ms"]:.4f} ms, {row["feed_launches"]} '
                f'launches; the call {row["call_launches"]} launches; the '
                f'call on the flat copy graph '
                f'{row["flat_call_graph_ms"]:.4f} ms; host '
                f'{row["host_us"]:.1f} us a call, cProfile (us a call): ' +
                ', '.join(f'{f} {t:.1f}' for f, t in row['host_top'])),
            flush=True)
        if ratio > 1.0:
            raise RuntimeError(f'probe 2 {name}: the decode is off its gate')

    for name, reg, args in decode_serving_calls(smoke):
        measure(name, args, feed=reg)
        del reg, args
        torch.cuda.empty_cache()

    ctx = AnchorContext.build(smoke.TRAIN_CANVAS)
    n = ctx.num_anchors
    case = smoke.train_case(np, torch, np.random.RandomState(5), ctx,
                            smoke.TRAIN_BATCH)
    centers, _ = ctx.device_tensors(smoke.DEV)
    unit = torch.ones(n, device=smoke.DEV)
    cap = n // 5 + 1
    _, ri, _, _ = ers_select(case['t_cls'], case['t_reg'], cap)
    for k in (1024, cap):
        rk = ri[:, :k].contiguous()
        measure(f'erd train K={k}', (case['t_reg'], rk, centers, unit, None))
    report['2'] = dict(calls=rows)
    del case
    torch.cuda.empty_cache()


def solo_decay_call(smoke):
    """The mask-IoU decay of one 800x1333 SOLOv2 R50 request
    (``chip_smoke.solo_net``, heads arranged): (scores after maskness,
    inter (1, 500, 500), area (1, 500), labels, sigma, kernel, the tree's
    own decay call's arguments and function name). ``inter`` and ``area``
    are computed from ``SOLOv2.select``'s captured inputs as it computes
    them, and held equal to what the tree's path hands its decay."""
    import numpy as np

    from erd_tpu_torch.utils import matmul_fp32_precision
    solo = importlib.import_module('erd_tpu_torch.models.detectors.solov2')
    det, net, batch, passing = smoke.solo_net(np, torch)
    fused = hasattr(solo, 'mask_matrix_decay')
    fname = 'mask_matrix_decay' if fused else 'matrix_decay'
    seen, decays = [], []
    cls = type(det)
    select = cls.select

    def wrapper(self, *args, **kw):
        seen.append(args)
        return select(self, *args, **kw)
    cls.select = wrapper
    undo = smoke.capture(solo, fname, decays)
    try:
        with torch.no_grad():
            det.predict(net, batch)
    finally:
        cls.select = select
        undo()
    torch.cuda.synchronize()
    if len(seen) != 1 or len(decays) != 1:
        raise RuntimeError(f'probe 12b: {len(seen)} select and '
                           f'{len(decays)} {fname} calls in a request')
    mpred = seen[0][3]
    binm = mpred > det.mask_thr
    area = binm.sum(-1).float()
    mflat = binm.float()
    with matmul_fp32_precision('ieee'):
        inter = torch.matmul(mflat, mflat.transpose(1, 2))
    got = decays[0]
    if fused:
        same = torch.equal(got[1], inter) and torch.equal(got[2], area)
        scores, labels, rest = got[0], got[3], got[4:]
    else:
        union = area[:, :, None] + area[:, None, :] - inter
        same = torch.equal(got[1], inter / union.clamp(min=1.0))
        scores, labels, rest = got[0], got[2], got[3:]
    if not same:
        raise RuntimeError('probe 12b: the IoU inputs differ from the '
                           'path\'s')
    del net, batch
    return dict(scores=scores, inter=inter, area=area, labels=labels,
                sigma=rest[0] if rest else 2.0,
                kernel=rest[1] if len(rest) > 1 else 'gaussian',
                path=fname, passing=passing)


# edits of csrc/extra_nms.cu for part 12b: the fused decay's kernel
# returning at once (a cooperative launch's own cost), with its grid-wide
# barrier replaced by a block barrier (the comps then wrong), with the row
# not held in registers over the barrier (pass 2 reloads and divides),
# with every term computed (no skipped work), with 8 row entries a lane in
# flight instead of 16, and at 128 or 512 threads a block (on no path)
MASK_DECAY_PARTS = {
    'empty': ({'  const size_t img = blockIdx.x / per;':
               '  if (n > 0) return;\n'
               '  const size_t img = blockIdx.x / per;'},),
    'no_grid_sync': ({'  cg::this_grid().sync();': '  __syncthreads();'},),
    'not_held': ({'  const bool held = step >= n && n <= 32 * kChunk;':
                  '  const bool held = false;'},),
    'dense': ({'  return !__syncthreads_or(odd);':
               '  return !__syncthreads_or(true);'},),
    'chunk_8': ({'constexpr int kChunk = 16;': 'constexpr int kChunk = 8;'},),
    'threads_128': ({'constexpr int kDecayThreads = 256;':
                     'constexpr int kDecayThreads = 128;'},),
    'threads_512': ({'constexpr int kDecayThreads = 256;':
                     'constexpr int kDecayThreads = 512;'},),
}


def probe_decay(smoke, report):
    """Part 12b, the matrix decay, at SOLOv2's request call (N = 500, its
    live slots) and the box form ``matrix_nms`` at K = 2000
    (``chip_smoke.random_nms_inputs``, RandomState(31), gaussian): by
    graph replays and events, plain, the bound (the IoU's bytes of the
    live rows, as the data needs them; ``chip_smoke.bound_of``), the
    largest relative error against plain (gate 1e-6, zeros equal), the
    launches; at SOLOv2's call the four elementwise launches that make the
    mask IoU (``solov2.py``'s union, clamp and division) timed apart, the
    parent's path (those and ``matrix_decay``) and, where the tree has
    it, the fused call ``mask_matrix_decay`` on inter and area and its
    ``MASK_DECAY_PARTS`` variants; the host's time an eager call; events
    are the median of five timings (``eager_ms``)."""
    import numpy as np

    ops = importlib.import_module('erd_tpu_torch.ops.extra_nms')
    c = solo_decay_call(smoke)
    s, inter, area, lab = c['scores'], c['inter'], c['area'], c['labels']
    sigma, kernel = c['sigma'], c['kernel']

    def miou():
        union = area[:, :, None] + area[:, None, :] - inter
        return inter / union.clamp(min=1.0)
    iou = miou()
    want = ops.matrix_decay_plain(s, iou, lab, sigma, kernel)

    def held(got):
        live = want != 0
        rel = float(((got - want).abs() / want.abs())[live].max()) \
            if bool(live.any()) else 0.0
        return rel, bool(torch.equal(got == 0, want == 0))
    n = s.shape[-1]
    live = int((s != 0).sum())
    nbytes = live * n * 4 + n * (4 + 4 + 8) + n * 4
    bms, by = smoke.bound_of(nbytes, live * n * 13.0)
    calls = {'feed (4 elementwise launches)': miou,
             'matrix_decay on the IoU': lambda: ops.matrix_decay(
                 s, iou, lab, sigma, kernel),
             'parent path (feed + matrix_decay)': lambda: ops.matrix_decay(
                 s, miou(), lab, sigma, kernel)}
    if hasattr(ops, 'mask_matrix_decay'):
        def fused():
            return ops.mask_matrix_decay(s, inter, area, lab, sigma, kernel)
        calls['mask_matrix_decay (fused)'] = fused
        for v, alts in MASK_DECAY_PARTS.items():
            lib = variant_lib('extra_nms', f'decay_{v}', alts)
            if lib is not None:
                calls[f'fused, {v}'] = functools.partial(
                    with_lib, 'extra_nms', lib, fused)
    row = dict(call='solov2 serve', n=n, live=live,
               cells_over_thr=c['passing'], path=c['path'], bound_ms=bms,
               bound_by=by, bytes=nbytes, library_ms=None,
               plain_ms=smoke.events_ms(torch, lambda: ops.matrix_decay_plain(
                   s, miou(), lab, sigma, kernel), 3), calls={})
    for name, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        entry = dict(graph_ms=smoke.graph_ms(torch, fn, 20),
                     events_ms=eager_ms(smoke, fn),
                     launches=graph_launches(fn))
        if name.startswith('fused, '):  # variants: timed, not gated
            entry['max_rel_err'], entry['zeros_equal'] = held(got)
        elif name != 'feed (4 elementwise launches)':
            entry['max_rel_err'], entry['zeros_equal'] = held(got)
            entry['host_us'], entry['host_top'] = host_profile(fn)
            if entry['max_rel_err'] > 1e-6 or not entry['zeros_equal']:
                raise RuntimeError(f'probe 12b {name}: off plain')
        row['calls'][name] = entry
    print(f'probe 12b solov2 serve: N={n}, {live} live slots '
          f'({c["passing"]} cells over score_thr), the path\'s decay '
          f'{c["path"]}; plain {row["plain_ms"]:.3f} ms, bound {bms:.6f} '
          f'({by}, {nbytes} bytes); ' + '; '.join(
              f'{k}: graph {v["graph_ms"]:.4f} ms, events '
              f'{v["events_ms"]:.4f}, {v["launches"]} launches' + (
                  f', max rel err {v["max_rel_err"]:.2e}, zeros equal '
                  f'{v["zeros_equal"]}, host {v["host_us"]:.1f} us a call'
                  if 'host_us' in v else '')
              for k, v in row['calls'].items()), flush=True)

    rs = np.random.RandomState(31)
    k = 2000
    boxes, sc, labels, valid = smoke.random_nms_inputs(np, torch, rs, k,
                                                       smoke.NUM_CLASSES)

    def box_call():
        return ops.matrix_nms(boxes, sc, labels, valid, kernel='gaussian')
    want = ops.matrix_nms_plain(boxes, sc, labels, valid, kernel='gaussian')
    rel, zeros = held(box_call())
    bms_k, by_k = smoke.bound_of(k * 32, k * k * (2 * 14 + 9.0))
    box = dict(call='matrix_nms K=2000 gaussian', k=k,
               graph_ms=smoke.graph_ms(torch, box_call, 20),
               events_ms=eager_ms(smoke, box_call),
               plain_ms=smoke.events_ms(torch, lambda: ops.matrix_nms_plain(
                   boxes, sc, labels, valid, kernel='gaussian'), 3),
               launches=graph_launches(box_call), bound_ms=bms_k,
               bound_by=by_k, max_rel_err=rel, zeros_equal=zeros,
               library_ms=None)
    print(f'probe 12b box form K={k}: graph {box["graph_ms"]:.4f} ms, events '
          f'{box["events_ms"]:.4f}, plain {box["plain_ms"]:.3f}, '
          f'{box["launches"]} launches, bound {bms_k:.6f} ({by_k}); max rel '
          f'err {rel:.2e}, zeros equal {zeros}', flush=True)
    if rel > 1e-6 or not zeros:
        raise RuntimeError('probe 12b box form: off plain')
    report['12b'] = dict(calls=[row, box])
    torch.cuda.empty_cache()


PARTS = {'8b': probe_deform, '9b': probe_attention,
         '9': probe_attention_forward, '7b': probe_roi_backward,
         '1': probe_nms, '7': probe_roi_forward, '10b': probe_carafe,
         '10': probe_carafe_forward, '13a-b': probe_point_backward,
         '3': probe_gfl_loss, '6': probe_atss, '4': probe_distill,
         '5': probe_ers, '11a': probe_soft_nms,
         '11a-floor': probe_soft_nms_floor, '15': probe_corner_targets,
         '13a': probe_point_forward, '14': probe_mask_targets,
         '2': probe_decode, '12b': probe_decay,
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
