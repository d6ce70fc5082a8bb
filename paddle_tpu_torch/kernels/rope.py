"""Rotary position embedding (split halves): CUDA kernel
(``csrc/rope.cu``), its plain PyTorch version, and the autograd wiring.

Replaces ``paddle_tpu/ops/pallas/rope.py:48 _rope_call`` and its custom
VJP (``rope.py:75-90``). Layout x [B, T, H, D], tables cos/sin in fp32,
[T, D/2] shared by the batch or [B, T, D/2] of each row's own positions
(the serving engine's batched step, where every slot sits at its own
position: the JAX engine gets the same from ``jax.vmap``). ``sign=-1`` rotates by the negative angle, which is the backward
of the forward rotation: the backward is the same kernel with the sign
flipped, and the tables get no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["apply_rotary", "apply_rotary_reference"]

_NAME = "rope"


def apply_rotary_reference(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor,
                           sign: float = 1.0) -> torch.Tensor:
    """Plain version: rotate split halves in fp32, cast back."""
    ct = _support.compute_dtype(x)
    d2 = x.shape[-1] // 2
    xf = x.to(ct)
    x1, x2 = xf[..., :d2], xf[..., d2:]
    lead = (slice(None),) if cos.ndim == 3 else (None,)
    c = cos.to(ct)[(*lead, slice(None), None)]
    s = sin.to(ct)[(*lead, slice(None), None)] * sign
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_rope
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rotate(x, cos, sin, sign: float, kernel: bool) -> torch.Tensor:
    """The rotation by the kernel (``kernel``) or the plain version."""
    if not kernel:
        return apply_rotary_reference(x, cos, sin, sign)
    B, T, H, D = x.shape
    code = _support.dtype_code(x)
    xc = x.contiguous()
    cf = cos.to(device=x.device, dtype=torch.float32).contiguous()
    sf = sin.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(xc)
    err = _entry()(xc.data_ptr(), cf.data_ptr(), sf.data_ptr(),
                   out.data_ptr(), B, T, H, D, int(cos.ndim == 3),
                   float(sign), code, _support.stream_of(xc))
    _support.check(err, _NAME)
    _support.LAUNCHES[_NAME] += 1
    return out


class _Rotary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin, sign):
        ctx.kernel = _support.use_kernel(x)
        ctx.sign = sign
        ctx.save_for_backward(cos, sin)
        return _rotate(x, cos, sin, sign, ctx.kernel)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return _rotate(g, cos, sin, -ctx.sign, ctx.kernel), None, None, None


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 sign: float = 1.0) -> torch.Tensor:
    """Rotate x [B, T, H, D] by [T, D/2] tables, or by [B, T, D/2]
    tables of each row's own positions; returns a new tensor of x's type,
    differentiable in x."""
    if x.ndim != 4 or x.shape[-1] % 2:
        raise ValueError(f"apply_rotary: x must be [B, T, H, D] with even "
                         f"D, got {tuple(x.shape)}")
    B, T, H, D = x.shape
    if cos.shape not in ((T, D // 2), (B, T, D // 2)) or \
            sin.shape != cos.shape:
        raise ValueError(f"apply_rotary: tables {tuple(cos.shape)}/"
                         f"{tuple(sin.shape)} do not match [T, D/2] = "
                         f"[{T}, {D // 2}] or [B, T, D/2]")
    return _Rotary.apply(x, cos, sin, float(sign))
