"""Softmax cross-entropy over [N, V] logits with int labels: CUDA kernels
(``csrc/softmax_xent.cu``), their plain PyTorch versions, and the
autograd wiring.

Replaces ``paddle_tpu/ops/pallas/softmax_xent.py:89 _lse_call`` (B14: the
per-row log-sum-exp, fp32 or bf16 logits in, fp32 out), ``:111 _dx_call``
(B15: ``exp(x − lse)·g`` in the logits' type) and their custom VJP
(``:141-169``). The per-row loss is ``lse − x[label]``; the label logit is
a gather outside the kernel, and the backward's ``−g`` at each label a
scatter-add outside it (``:165-166``). The autograd function keeps the
logits (an input) and the [N] lse, never the [N, V] probabilities.

``nn.functional.softmax_with_cross_entropy`` dispatches here under the
JAX package's gate (``paddle_tpu/nn/functional.py:333-363``, and
``supported`` below): last axis, int labels, no soft labels, ``V % 256 ==
0`` and ``V <= DISPATCH_MAX_V``, fp32 or bf16, rows padded to a multiple
of 128 (of 8 below 128 rows). The CUDA kernels themselves take any N and
V.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["softmax_cross_entropy", "supported", "row_pad", "lse",
           "lse_reference", "dx", "dx_reference", "BLOCK_N", "BLOCK_V",
           "DISPATCH_MAX_V"]

_LSE_NAME = "softmax_xent_lse"
_DX_NAME = "softmax_xent_dx"
BLOCK_N = 128
BLOCK_V = 256
# The JAX package's dispatch ceiling on the vocabulary (softmax_xent.py:39)
DISPATCH_MAX_V = 2048


def row_pad(n: int) -> int:
    """Rows to append so that ``n`` tiles by the row block: 128, or 8
    below 128 rows (``paddle_tpu/nn/functional.py:349``)."""
    return (-n) % (BLOCK_N if n >= BLOCK_N else 8)


def supported(logits, labels) -> bool:
    """The JAX kernel's shape and type gate (``softmax_xent.py:42-53``)."""
    if logits.ndim != 2 or labels.ndim != 1:
        return False
    n, v = logits.shape
    if labels.shape[0] != n:
        return False
    if n % min(BLOCK_N, n) or n % 8 or v % BLOCK_V:
        return False
    return logits.dtype in (torch.float32, torch.bfloat16)


def lse_reference(x):
    """Plain version of B14: per-row log-sum-exp of [N, V] in fp32 (fp64
    for fp64), against the row's maximum. Returns [N]."""
    xf = x.to(_support.compute_dtype(x))
    m = xf.amax(dim=1, keepdim=True)
    return (m + torch.log(torch.exp(xf - m).sum(dim=1, keepdim=True)))[:, 0]


def dx_reference(x, lse_, g):
    """Plain version of B15: ``exp(x − lse)·g`` per row, computed in fp32
    and returned in x's type. ``lse_`` and ``g`` are [N]."""
    ct = _support.compute_dtype(x)
    return (torch.exp(x.to(ct) - lse_.to(ct)[:, None])
            * g.to(ct)[:, None]).to(x.dtype)


@functools.cache
def _lse_entry():
    fn = _support.library(_LSE_NAME).ptt_softmax_xent_lse
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _dx_entry():
    fn = _support.library(_DX_NAME).ptt_softmax_xent_dx
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lse_kernel(x):
    n, v = x.shape
    code = _support.dtype_code(x)
    xc = x.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    err = _lse_entry()(xc.data_ptr(), out.data_ptr(), n, v, code,
                       _support.stream_of(xc))
    _support.check(err, _LSE_NAME)
    _support.LAUNCHES[_LSE_NAME] += 1
    return out


def _dx_kernel(x, lse_, g):
    n, v = x.shape
    code = _support.dtype_code(x)
    xc = x.contiguous()
    lf = lse_.to(torch.float32).contiguous()
    gf = g.to(torch.float32).contiguous()
    if lf.shape != (n,) or gf.shape != (n,):
        raise ValueError(f"softmax_xent dx: lse {tuple(lf.shape)} and g "
                         f"{tuple(gf.shape)} must be [{n}]")
    out = torch.empty_like(xc)
    err = _dx_entry()(xc.data_ptr(), lf.data_ptr(), gf.data_ptr(),
                      out.data_ptr(), n, v, code, _support.stream_of(xc))
    _support.check(err, _DX_NAME)
    _support.LAUNCHES[_DX_NAME] += 1
    return out


def _check(x):
    if x.ndim != 2 or 0 in x.shape:
        raise ValueError(f"softmax_xent: logits must be a non-empty [N, V], "
                         f"got {tuple(x.shape)}")


def lse(x):
    """B14: per-row log-sum-exp of [N, V] logits (fp32 or bf16) → fp32
    [N]; the kernel on a CUDA tensor, the plain version on a CPU one."""
    _check(x)
    return _lse_kernel(x) if _support.use_kernel(x) else lse_reference(x)


def dx(x, lse_, g):
    """B15: ``exp(x − lse)·g`` per row in x's type; the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    _check(x)
    if _support.use_kernel(x):
        return _dx_kernel(x, lse_, g)
    return dx_reference(x, lse_, g)


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.kernel = _support.use_kernel(logits)
        lse_ = _lse_kernel(logits) if ctx.kernel else lse_reference(logits)
        sel = torch.gather(logits, 1, labels[:, None])[:, 0]
        ctx.save_for_backward(logits, labels, lse_)
        return lse_ - sel.to(lse_.dtype)

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse_ = ctx.saved_tensors
        g = g.to(lse_.dtype)
        grad = (_dx_kernel(logits, lse_, g) if ctx.kernel
                else dx_reference(logits, lse_, g))
        rows = torch.arange(labels.shape[0], device=labels.device)
        grad.index_put_((rows, labels), (-g).to(grad.dtype),
                        accumulate=True)
        return grad, None


def softmax_cross_entropy(logits, labels):
    """Per-row loss ``lse(logits) − logits[labels]`` (fp32 [N]) for [N, V]
    logits and int [N] labels in ``[0, V)``, differentiable in the
    logits: B14 forward and B15 backward on CUDA tensors, their plain
    versions on CPU tensors. ``supported(logits, labels)`` must hold."""
    if not supported(logits, labels):
        raise ValueError(f"softmax_cross_entropy: logits "
                         f"{tuple(logits.shape)} {logits.dtype}, labels "
                         f"{tuple(labels.shape)} outside the kernel's gate "
                         f"(N % 8, N % min(128, N), V % {BLOCK_V}, fp32 or "
                         "bf16)")
    return _SoftmaxXent.apply(logits, labels.long())
