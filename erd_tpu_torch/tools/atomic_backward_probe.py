"""Where the two atomic backward kernels spend their time, on one CUDA GPU:
the deformable im2col backward (``erd_deform_im2col_backward``, kernel 8b)
and the multi-scale deformable attention backward
(``erd_ms_deform_attn_backward``, kernel 9b). Run from the repository root:

    python3 -m erd_tpu_torch.tools.atomic_backward_probe

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

Prints a line per measurement and, last, one JSON object of them all.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import os
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


def captured_calls(smoke, module, name, net_fn, kinds, key_fn):
    """{kind: {key: [args, count]}}: the first call of each key of one
    training step of each config, and how many calls share the key."""
    import numpy as np

    from erd_tpu_torch.engine import batch_to
    out = {}
    for kind in kinds:
        _, det, net = net_fn(torch, kind)
        batch = batch_to(next(iter(smoke.SyntheticLoader(
            np, torch, 1, seed=41, num_labels=smoke.NUM_CLASSES).epoch(0))),
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


def main() -> int:
    if not torch.cuda.is_available():
        print('atomic_backward_probe: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smoke = importlib.import_module('chip_smoke')
    card = smoke.card_line()
    print(card, flush=True)
    report = {'card': card}
    probe_deform(smoke, report)
    probe_attention(smoke, report)
    print(json.dumps(report))
    return 0


if __name__ == '__main__':
    sys.exit(main())
