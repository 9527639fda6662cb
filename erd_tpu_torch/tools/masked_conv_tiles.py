"""The masked conv's tiles (kernel 13b, ``csrc/masked_conv.cu``) on one
CUDA GPU. Run from the repository root:

    python3 -m erd_tpu_torch.tools.masked_conv_tiles

1. A 3x3, 256 -> 256 float32 conv on 100 x 168 maps (SOLOv2's P3, the size
   chip_smoke.py times) under masks of exactly P positions (one map, or two
   past 16800): every tile of MASKED_CONV_TILES held to the plain version
   (masked-out outputs exactly 0, the rest within 1e-5 * max|plain|) and
   timed by CUDA-graph replays (the launch with its weight copy and
   zeroing), beside the tile ``masked_conv_tile`` picks and the fastest.
2. At 50 and 100 % of one map: the parts of one ``masked_conv2d`` call by
   CUDA events, the call itself, the nonzero (with its host
   synchronisation), the gather of the mask's values, and by graph
   replays the weight's copy to (Co, K, K, Cin), the output's zeroing and
   the launch.

Prints a line per measurement and, last, one JSON object of them all.
"""
from __future__ import annotations

import importlib
import json
import os
import sys

import torch

from ..ops.sampling import (MASKED_CONV_TILES, masked_conv2d,
                            masked_conv2d_plain, masked_conv_positions,
                            masked_conv_tile)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
H, W, C = 100, 168, 256
# positions: each side of the tile choices on 132 SMs, and two maps' worth
POSITIONS = (848, 2000, 4272, 5400, 6300, 7500, 8300, 8391, 8448, 8500,
             9000, 10000, 12000, 14000, 16700, 16800, 20000, 25000, 33600)


def exact_mask(p, gen, dev):
    """(B, H, W) bool mask of exactly p positions (B = 1, or 2 past one
    map), drawn from gen."""
    b = 1 if p <= H * W else 2
    flat = torch.zeros(b * H * W, dtype=torch.bool)
    flat[torch.randperm(b * H * W, generator=gen)[:p]] = True
    return flat.reshape(b, H, W).to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print('masked_conv_tiles: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smoke = importlib.import_module('chip_smoke')
    card = smoke.card_line()
    print(card, flush=True)
    dev = torch.device('cuda', 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(13)
    x2 = torch.randn(2, C, H, W, generator=gen).to(dev)
    w = (torch.randn(C, C, 3, 3, generator=gen) / 48).to(dev)
    b = torch.randn(C, generator=gen).to(dev)
    report = {'card': card, 'sm_count': sms, 'tiles': [], 'call': []}
    ok = True
    for p in POSITIONS:
        mask = exact_mask(p, gen, dev)
        x = x2[:mask.shape[0]]
        want = masked_conv2d_plain(x, mask, w, b)
        lim = 1e-5 * float(want.abs().max())
        flat = mask.reshape(-1)
        pos = torch.nonzero(flat).reshape(-1)
        maskv = flat[pos].float()
        ms, err = {}, {}
        for t in MASKED_CONV_TILES:
            def launch(t=t):
                return masked_conv_positions(x, w, b, maskv, pos, 1, (H, W),
                                             t)
            got = launch()
            off = ~mask[:, None].expand_as(got)
            err[t] = float((got - want).abs().max())
            ok &= bool((got[off] == 0).all()) and err[t] <= lim
            ms[t] = smoke.graph_ms(torch, launch)
        chosen = masked_conv_tile(p, C, sms)
        fastest = min(ms, key=ms.get)
        report['tiles'].append(dict(positions=p, maps=mask.shape[0], ms=ms,
                                    max_abs_err=err, limit=lim,
                                    chosen=chosen, fastest=fastest))
        print(f'masked conv tiles: P={p}: ' + ', '.join(
            f'tile {t} {MASKED_CONV_TILES[t]} {v:.4f} ms'
            for t, v in ms.items()) + f'; masked_conv_tile picks {chosen}, '
            f'fastest {fastest} ({ms[chosen] / ms[fastest] - 1:+.1%}); '
            f'max err {max(err.values()):.2e} (limit {lim:.2e})', flush=True)
    for density in (0.5, 1.0):
        mask = exact_mask(round(density * H * W), gen, dev)
        x = x2[:1]
        flat = mask.reshape(-1)
        pos = torch.nonzero(flat).reshape(-1)
        maskv = flat[pos].float()
        parts = {
            'call': smoke.events_ms(
                torch, lambda: masked_conv2d(x, mask, w, b), 10),
            'nonzero': smoke.events_ms(
                torch, lambda: torch.nonzero(flat), 10),
            'gather': smoke.events_ms(
                torch, lambda: flat[pos].float().contiguous(), 10),
            'weight copy': smoke.graph_ms(
                torch, lambda: w.permute(0, 2, 3, 1).contiguous()),
            'zeroing': smoke.graph_ms(
                torch, lambda: torch.zeros(1, C, H, W, device=dev)),
            'launch': smoke.graph_ms(torch, lambda: masked_conv_positions(
                x, w, b, maskv, pos, 1, (H, W)))}
        report['call'].append(dict(density=density, positions=pos.numel(),
                                   ms=parts))
        print(f'masked conv call: density {density:g} ({pos.numel()} '
              f'positions): ' + ', '.join(
                  f'{k} {v:.4f} ms' for k, v in parts.items()), flush=True)
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
