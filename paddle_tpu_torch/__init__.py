"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package is held
against it by the ``tests/test_torch_*.py`` parity tests. Plain tensor
code is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++
kernel for Hopper (``paddle_tpu_torch/csrc``), built with ``nvcc`` at
first use and bound through ``ctypes`` (``kernels/_support.py``).

Entry points put parameters, caches and outputs on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU they raise rather than run
quietly on the host. On CPU tensors every kernel wrapper runs its plain
PyTorch version.

This package never imports ``jax`` or ``paddle_tpu``.
"""

from paddle_tpu_torch.version import __version__
from paddle_tpu_torch.device import make_generator, resolve_device

__all__ = ["__version__", "make_generator", "resolve_device"]
