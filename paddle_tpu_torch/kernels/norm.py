"""RMSNorm forward: CUDA kernel (``csrc/rms_norm.cu``) and its plain
PyTorch version.

Replaces ``paddle_tpu/ops/pallas/norm.py:78 _rms_fwd``. Numerics follow
the Pallas kernel: statistics and the product with ``w`` in fp32, one
cast at the end. (The JAX package's plain ``rms_norm`` casts ``xhat`` to
the input type before multiplying by ``w``; the two agree exactly in
fp32 and by about one ulp in bf16.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["rms_norm", "rms_norm_reference"]

_NAME = "rms_norm"


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       epsilon: float = 1e-6) -> torch.Tensor:
    """Plain version: the kernel's arithmetic in PyTorch ops."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    return (xf * rstd * weight.float()).to(x.dtype)


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_rms_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any leading shape, any row
    count). ``weight`` [H] in the type of ``x``."""
    if not _support.use_kernel(x):
        return rms_norm_reference(x, weight, epsilon)
    h = x.shape[-1]
    if weight.shape != (h,) or weight.dtype != x.dtype \
            or weight.device != x.device:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} "
                         f"{weight.dtype} on {weight.device} does not match "
                         f"x [..., {h}] {x.dtype} on {x.device}")
    code = _support.dtype_code(x)
    xc = x.contiguous()
    wc = weight.contiguous()
    y = torch.empty_like(xc)
    n = xc.numel() // h
    err = _entry()(xc.data_ptr(), wc.data_ptr(), y.data_ptr(), n, h,
                   float(epsilon), code, _support.stream_of(xc))
    _support.check(err, _NAME)
    _support.LAUNCHES[_NAME] += 1
    return y
