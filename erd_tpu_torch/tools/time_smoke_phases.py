"""Seconds spent in each phase of a ``chip_smoke.py``, on one CUDA GPU:
runs the script's ``main`` with every ``phase_*`` function timed by the
host clock, and prints, last, one JSON object: the script, its return
code, its seconds in all, and each phase's. Run by path, so that the
script under test imports its own tree's ``erd_tpu_torch`` (this file
imports nothing of the package):

    python3 erd_tpu_torch/tools/time_smoke_phases.py [path/to/chip_smoke.py]
        [--only phase_a,phase_b]

The script's own output comes first, as ``python3 chip_smoke.py`` prints
it; what ``main`` spends outside the phases (the kernels' build, the
result lines) is ``outside phases``. With ``--only``, the kernels are
built and the named phases alone run, in that order (a phase that takes
the card line gets it), instead of ``main``: one script's train phases,
say, run again and again beside another tree's.
"""
from __future__ import annotations

import functools
import importlib.util
import inspect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def timed_phases(smoke, spent):
    """Wrap every ``phase_*`` function of module ``smoke`` so that its
    seconds add up in ``spent[name]``."""
    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return run
    for name in [n for n in vars(smoke) if n.startswith('phase_')]:
        setattr(smoke, name, timed(name, getattr(smoke, name)))


def run_phases(smoke, names) -> int:
    """Build the script's kernels (as its ``main`` does) and run the named
    phases alone, in order."""
    import numpy as np
    import torch
    sys.path.insert(0, smoke.ROOT)
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(
        smoke.ROOT, 'erd_tpu_torch', 'csrc', 'build', 'triton'))
    from erd_tpu_torch.ops import cuda_build
    card = smoke.card_line()
    print(card, flush=True)
    cuda_build.build()
    for name in names:
        fn = getattr(smoke, name)
        fn(*((np, torch, card) if 'card' in inspect.signature(fn).parameters
             else (np, torch)))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if '--only' in argv:
        i = argv.index('--only')
        only = argv[i + 1].split(',')
        argv = argv[:i] + argv[i + 2:]
    path = os.path.abspath(argv[0] if argv else
                           os.path.join(ROOT, 'chip_smoke.py'))
    spec = importlib.util.spec_from_file_location('timed_smoke', path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    spent = {}
    timed_phases(smoke, spent)
    t0 = time.perf_counter()
    rc = smoke.main() if only is None else run_phases(smoke, only)
    total = time.perf_counter() - t0
    print(json.dumps({'script': path, 'rc': rc, 'seconds': total,
                      'outside phases': total - sum(spent.values()),
                      'phases': spent}), flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
