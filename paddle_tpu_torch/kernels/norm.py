"""RMSNorm forward and backward: CUDA kernels (``csrc/rms_norm.cu``), their
plain PyTorch versions, and the autograd wiring.

Replaces ``paddle_tpu/ops/pallas/norm.py:78 _rms_fwd`` (which also saves
the row ``rstd``), ``norm.py:102 _rms_bwd_call`` and their custom VJP
(``norm.py:137-158``). Numerics follow the Pallas kernels: statistics
and the product with ``w`` in fp32, one cast at the end; ``dw`` summed in
fp32 and cast to the weight's type. (The JAX package's plain ``rms_norm``
casts ``xhat`` to the input type before multiplying by ``w``; the two
agree exactly in fp32 and by about one ulp in bf16.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["rms_norm", "rms_norm_reference", "rms_norm_bwd",
           "rms_norm_bwd_reference"]

_NAME = "rms_norm"
_BWD_NAME = "rms_norm_bwd"
MAX_H = 16384        # the backward keeps one dw row in shared memory
BWD_BLOCKS = 512     # partial dw rows: fixed, so the sum order is too


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       epsilon: float = 1e-6, *, return_rstd: bool = False):
    """Plain version: the kernel's arithmetic in PyTorch ops. With
    ``return_rstd`` also the row statistic rstd (``x.shape[:-1]``)."""
    ct = _support.compute_dtype(x)
    xf = x.to(ct)
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    y = (xf * rstd * weight.to(ct)).to(x.dtype)
    return (y, rstd[..., 0]) if return_rstd else y


def rms_norm_bwd_reference(x, weight, rstd, g):
    """Plain backward: ``(dx [x's shape and type], dw [H] in fp32)`` from
    the forward's input, weight and rstd and the output gradient ``g``."""
    ct = _support.compute_dtype(x)
    h = x.shape[-1]
    r = rstd.to(ct)[..., None]
    xhat = x.to(ct) * r
    gf = g.to(ct)
    wg = gf * weight.to(ct)
    c = (wg * xhat).mean(dim=-1, keepdim=True)
    dx = (r * (wg - xhat * c)).to(x.dtype)
    dw = (gf * xhat).reshape(-1, h).sum(dim=0)
    return dx, dw


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_rms_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = _support.library(_BWD_NAME).ptt_rms_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_weight(x, weight):
    h = x.shape[-1]
    if weight.shape != (h,) or weight.dtype != x.dtype \
            or weight.device != x.device:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} "
                         f"{weight.dtype} on {weight.device} does not match "
                         f"x [..., {h}] {x.dtype} on {x.device}")


def _fwd_kernel(x, weight, epsilon):
    """The forward kernel: ``(y, rstd [x.shape[:-1]] fp32)``."""
    _check_weight(x, weight)
    code = _support.dtype_code(x)
    h = x.shape[-1]
    xc = x.contiguous()
    wc = weight.contiguous()
    y = torch.empty_like(xc)
    rstd = torch.empty(x.shape[:-1], device=x.device, dtype=torch.float32)
    n = xc.numel() // h
    err = _entry()(xc.data_ptr(), wc.data_ptr(), y.data_ptr(),
                   rstd.data_ptr(), n, h, float(epsilon), code,
                   _support.stream_of(xc))
    _support.check(err, _NAME)
    _support.LAUNCHES[_NAME] += 1
    return y, rstd


def _bwd_kernel(x, weight, rstd, g):
    """The backward kernel: ``(dx, dw [H] fp32)``."""
    _check_weight(x, weight)
    h = x.shape[-1]
    if h > MAX_H:
        raise ValueError(f"rms_norm backward kernel: H={h} > {MAX_H}")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"rms_norm backward: g {tuple(g.shape)} {g.dtype}"
                         f" does not match x {tuple(x.shape)} {x.dtype}")
    if rstd.dtype != torch.float32 or rstd.numel() * h != x.numel():
        raise ValueError("rms_norm backward: rstd must be the forward's "
                         "fp32 row statistic")
    code = _support.dtype_code(x)
    xc, gc, wc, rc = (t.contiguous() for t in (x, g, weight, rstd))
    n = xc.numel() // h
    blocks = min(n, BWD_BLOCKS)
    dx = torch.empty_like(xc)
    part = torch.empty((blocks, h), device=x.device, dtype=torch.float32)
    dw = torch.empty((h,), device=x.device, dtype=torch.float32)
    err = _bwd_entry()(xc.data_ptr(), wc.data_ptr(), rc.data_ptr(),
                       gc.data_ptr(), dx.data_ptr(), part.data_ptr(),
                       dw.data_ptr(), n, h, blocks, code,
                       _support.stream_of(xc))
    _support.check(err, _BWD_NAME)
    _support.LAUNCHES[_BWD_NAME] += 1
    return dx, dw


def rms_norm_bwd(x, weight, rstd, g):
    """RMSNorm backward on its own: the kernel on CUDA tensors, the plain
    version on CPU tensors. Returns ``(dx, dw [H] fp32)``."""
    if _support.use_kernel(x):
        return _bwd_kernel(x, weight, rstd, g)
    return rms_norm_bwd_reference(x, weight, rstd, g)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, epsilon):
        ctx.kernel = _support.use_kernel(x)
        if ctx.kernel:
            y, rstd = _fwd_kernel(x, weight, epsilon)
        else:
            y, rstd = rms_norm_reference(x, weight, epsilon,
                                         return_rstd=True)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        bwd = _bwd_kernel if ctx.kernel else rms_norm_bwd_reference
        dx, dw = bwd(x, weight, rstd, g)
        return dx, dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any leading shape, any row
    count), differentiable in ``x`` and ``weight`` [H] (in the type of
    ``x``)."""
    return _RMSNorm.apply(x, weight, float(epsilon))
