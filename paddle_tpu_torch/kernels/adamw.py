"""AdamW update of one parameter tensor, in place: CUDA kernel
(``csrc/adamw.cu``) and its plain PyTorch version.

Replaces ``paddle_tpu/ops/pallas/adamw.py:39 adamw_update``, the fused
single pass that the JAX package keeps for eager, out-of-jit use
(``paddle_tpu/optimizer/optimizers.py:124-129``); the port runs eagerly,
so its optimizer step is one such pass per parameter tensor. Moments are
fp32, the parameter and the gradient keep their own types. Unlike the
Pallas kernel, which returns new arrays, both versions here update
``p``, ``m`` and ``v`` in place and return them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["adamw_update", "adamw_update_reference", "update_mismatch"]

_NAME = "adamw"


def _bias_corrections(beta1: float, beta2: float, step: int):
    """``(1 / (1 - beta1**step), 1 / (1 - beta2**step))`` for the 1-based
    ``step``."""
    return 1.0 / (1.0 - beta1 ** step), 1.0 / (1.0 - beta2 ** step)


def _complement(beta: float) -> float:
    """``1 - beta`` as both kernels take it: in fp32, from beta rounded to
    fp32 (at beta 0.999 that is 1.3e-5 off the exact complement)."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 - torch.tensor(beta, dtype=torch.float32))


def adamw_update_reference(p, m, v, g, *, lr, beta1=0.9, beta2=0.999,
                           eps=1e-8, weight_decay=0.01, step):
    """Plain version: the kernel's arithmetic in PyTorch ops, in place."""
    c1, c2 = _bias_corrections(beta1, beta2, step)
    with torch.no_grad():
        gf = g.to(m.dtype)
        m.copy_(beta1 * m + _complement(beta1) * gf)
        v.copy_(beta2 * v + _complement(beta2) * gf * gf)
        pf = p.to(m.dtype)
        update = (m * c1) / (torch.sqrt(v * c2) + eps)
        p.copy_(pf - lr * (update + weight_decay * pf))
    return p, m, v


def update_mismatch(before, g, got, want, *, lr, step, beta1=0.9,
                    beta2=0.999, eps=1e-8, weight_decay=0.01):
    """How far one AdamW step ``got = (p, m, v)`` lies from ``want`` (the
    plain version's step from the same ``before = (p0, m0, v0)``, gradient
    ``g`` and hyperparameters), as the largest ratio of a difference to
    its tolerance: 1 or less means they agree.

    Both do the same fp32 arithmetic, a few fp32 ulps apart (the kernel
    contracts products into FMAs), so each output is held at 1e-5 of the
    terms it sums, which may cancel: m at 1e-5 of ``beta1·|m0| +
    (1 − beta1)·|g|``, v at 1e-5 of itself (its terms cannot cancel), and
    p at one ulp of its own type (the two round values that differ in
    their last fp32 bits) plus 1e-5 of the step's terms, ``lr·(c1·(that
    m scale) / (sqrt(c2·v) + eps) + weight_decay·|p0|)``. A kernel that
    writes nothing, or takes a wrong bias correction, misses by far more
    wherever the step spans a few ulps of p."""
    c1, c2 = _bias_corrections(beta1, beta2, step)
    gf = g.float()
    m_scale = beta1 * before[1].abs() + (1 - beta1) * gf.abs()

    def ratio(diff, tol):
        return (diff.abs() / tol.clamp_min(torch.finfo(torch.float32).tiny)
                ).max().item()

    worst = ratio(got[1] - want[1], 1e-5 * m_scale)
    worst = max(worst, ratio(got[2] - want[2], 1e-5 * (
        beta2 * before[2] + (1 - beta2) * gf * gf)))
    step_scale = lr * (c1 * m_scale / (torch.sqrt(c2 * want[2]) + eps)
                       + weight_decay * before[0].float().abs())
    del m_scale
    pr = want[0].float()
    _, exp = torch.frexp(pr)
    ulp = torch.finfo(want[0].dtype).eps * torch.ldexp(
        torch.ones_like(pr), exp - 1)
    return max(worst, ratio(got[0].float() - pr, ulp + 1e-5 * step_scale))


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_adamw
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [
        ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel(p, m, v, g, *, lr, beta1, beta2, eps, weight_decay, step):
    if not (p.shape == m.shape == v.shape == g.shape):
        raise ValueError(f"adamw_update: shapes p {tuple(p.shape)}, m "
                         f"{tuple(m.shape)}, v {tuple(v.shape)}, g "
                         f"{tuple(g.shape)} differ")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("adamw_update: moments must be float32")
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError("adamw_update: p, m and v are updated in place "
                         "and must be contiguous")
    if not (p.device == m.device == v.device == g.device):
        raise ValueError("adamw_update: tensors on different devices")
    p_code, g_code = _support.dtype_code(p), _support.dtype_code(g)
    gc = g.contiguous()
    c1, c2 = _bias_corrections(beta1, beta2, step)
    err = _entry()(p.data_ptr(), m.data_ptr(), v.data_ptr(), gc.data_ptr(),
                   p.numel(), float(lr), float(beta1), float(beta2),
                   float(eps), float(weight_decay), float(c1), float(c2),
                   p_code, g_code, _support.stream_of(p))
    _support.check(err, _NAME)
    _support.LAUNCHES[_NAME] += 1
    return p, m, v


def adamw_update(p, m, v, g, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, step):
    """One AdamW step on a single tensor, in place; returns ``(p, m, v)``.
    ``m``/``v`` float32; ``step`` is the 1-based count used for the bias
    corrections. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    fn = _kernel if _support.use_kernel(p) else adamw_update_reference
    return fn(p, m, v, g, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step)
