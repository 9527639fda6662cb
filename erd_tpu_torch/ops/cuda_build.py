"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``csrc/build/`` at first
use, named after a hash of its source and flags so that an edited source is
rebuilt, and loaded with ``ctypes``. Nothing here runs at import time.

Flags: no ``--use_fast_math``, and ``-fmad=false`` so that nvcc never
contracts a multiply and an add into one FMA: the NMS, soft-NMS, ATSS and
RoIAlign kernels must round every IoU, distance and sample exactly as the
plain versions do, the deformable-attention and deformable-im2col kernels
must round every bilinear sample as their plain versions do, the CARAFE
kernel every product and sum of its reassembly, the point-sample kernel
every product and sum of its bilinear weights, the mask-target kernel
every step from an RoI's cell to a crop's corners (a floor near an integer
must land where erd_tpu's does), the corner-target kernel each
gaussian's exponent, and the matrix-NMS, fast-NMS and nms_match kernels
every IoU and decay term. (The masked-conv kernel chains explicit FMAs;
the GFL-loss kernels call the fast exp, log and divide intrinsics; the
distillation kernels the accurate ``expf`` and ``logf``.) Every kernel of
the port is CUDA C++; none is Triton.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = CSRC / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')
SOURCES = ('nms', 'integral_decode', 'atss', 'ers_select', 'roi_align',
           'soft_nms', 'ms_deform_attn', 'deform_conv', 'carafe',
           'point_sample', 'corner_pool', 'mask_target', 'corner_targets',
           'extra_nms', 'masked_conv', 'gfl_loss', 'erd_distill')

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each build made by this process
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set CUDA_HOME or put nvcc on PATH)')


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha1(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:12]}.so'


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        lib = library_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f'{name}.cu (exit {proc.returncode}):\n{log}')
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.erd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.erd_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def entry(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``'s library, its
    argument and result types set on its first call (ctypes keeps one
    function object a library and symbol), so that a wrapper's call sets
    nothing."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


_SAME_DEVICE = contextlib.nullcontext()


def on_device(device):
    """A context for a launch on ``device`` (a CUDA torch.device): none
    where it is the current device already, else ``torch.cuda.device``."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def stream_handle(device) -> int:
    """The handle of ``device``'s current CUDA stream, by torch's raw
    getter (no ``torch.cuda.Stream`` object built a call)."""
    import torch
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.erd_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
