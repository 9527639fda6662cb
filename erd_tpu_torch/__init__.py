"""erd_tpu_torch: the PyTorch + CUDA port of erd_tpu for NVIDIA Hopper.

The package mirrors ``erd_tpu``'s module layout and names; ``erd_tpu`` stays
the reference every part of the port is held against. It imports ``torch``
and never ``jax``, ``flax`` or ``erd_tpu``.

Entry points (``apis.init_detector``) run on ``cuda`` unless the caller
passes ``device='cpu'``; without CUDA and without a device they raise. The
hand-written kernels live in ``csrc/`` and are built with ``nvcc`` at first
use (``ops/cuda_build.py``); each wrapper launches its kernel for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.
"""
