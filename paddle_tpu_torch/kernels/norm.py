"""RMSNorm and LayerNorm, forward and backward: CUDA kernels
(``csrc/rms_norm.cu``, ``csrc/layer_norm.cu``), their plain PyTorch
versions, and the autograd wiring.

RMSNorm replaces ``paddle_tpu/ops/pallas/norm.py:78 _rms_fwd`` (which also
saves the row ``rstd``), ``norm.py:102 _rms_bwd_call`` and their custom
VJP (``norm.py:137-158``). Numerics follow the Pallas kernels: statistics
and the product with ``w`` in fp32, one cast at the end; ``dw`` summed in
fp32 and cast to the weight's type. (The JAX package's plain ``rms_norm``
casts ``xhat`` to the input type before multiplying by ``w``; the two
agree exactly in fp32 and by about one ulp in bf16.)

LayerNorm replaces ``norm.py:212 _ln_fwd`` (y, and the row mean and rstd
in fp32), ``norm.py:256 _ln_bwd_call`` (dx; dw and db summed over rows)
and their custom VJP (``norm.py:245-297``), with the Pallas kernels'
numerics: a two-pass mean and variance in fp32, ``y = xhat·w + b`` in
fp32 cast once; ``dw``, ``db`` summed in fp32 and cast to the
parameters' types. (The JAX package's plain ``layer_norm``, which its
``nn.LayerNorm`` runs, computes in the input type: in bf16 it is the
looser of the two.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["rms_norm", "rms_norm_reference", "rms_norm_bwd",
           "rms_norm_bwd_reference", "layer_norm", "layer_norm_reference",
           "layer_norm_bwd", "layer_norm_bwd_reference",
           "layer_norm_mismatch", "layer_norm_bwd_mismatch"]

_NAME = "rms_norm"
_BWD_NAME = "rms_norm_bwd"
_LN_NAME = "layer_norm"
_LN_BWD_NAME = "layer_norm_bwd"
MAX_H = 16384        # the backward keeps one dw (and db) row in shared memory
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


# --------------------------------------------------------------- LayerNorm

def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, epsilon: float = 1e-5, *,
                         return_stats: bool = False):
    """Plain version: the kernel's arithmetic in PyTorch ops. With
    ``return_stats`` also the row statistics ``(mean, rstd)``
    (``x.shape[:-1]``)."""
    ct = _support.compute_dtype(x)
    xf = x.to(ct)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + epsilon)
    y = ((xf - mean) * rstd * weight.to(ct) + bias.to(ct)).to(x.dtype)
    return (y, mean[..., 0], rstd[..., 0]) if return_stats else y


def layer_norm_bwd_reference(x, weight, mean, rstd, g):
    """Plain backward: ``(dx [x's shape and type], dw [H] fp32, db [H]
    fp32)`` from the forward's input, weight, row statistics and the
    output gradient ``g``."""
    ct = _support.compute_dtype(x)
    h = x.shape[-1]
    r = rstd.to(ct)[..., None]
    xhat = (x.to(ct) - mean.to(ct)[..., None]) * r
    gf = g.to(ct)
    wg = gf * weight.to(ct)
    c1 = wg.mean(dim=-1, keepdim=True)
    c2 = (wg * xhat).mean(dim=-1, keepdim=True)
    dx = (r * (wg - c1 - xhat * c2)).to(x.dtype)
    dw = (gf * xhat).reshape(-1, h).sum(dim=0)
    db = gf.reshape(-1, h).sum(dim=0)
    return dx, dw, db


def _ratio(got, want, scale) -> float:
    """The largest ``|got − want| / (ulp(want) + 1e-5·scale)``: one ulp of
    ``want``'s own type (two roundings of fp32 values a few fp32 ulps
    apart differ by at most one) plus 1e-5 of the terms the value sums,
    which may cancel."""
    wf = want.float()
    _, exp = torch.frexp(wf)
    ulp = torch.finfo(want.dtype).eps * torch.ldexp(torch.ones_like(wf),
                                                    exp - 1)
    tol = (ulp + 1e-5 * scale).clamp_min(torch.finfo(torch.float32).tiny)
    return ((got.float() - wf).abs() / tol).max().item()


def layer_norm_mismatch(x, weight, bias, got, want) -> float:
    """How far the forward's ``got`` y lies from ``want`` (the plain
    version's on the same inputs), as the largest ratio of a difference to
    its tolerance: 1 or less means they agree. y is held at one ulp of its
    type plus 1e-5 of ``(|x| + |mean|)·rstd·|w| + |b|`` (the terms of
    ``(x − mean)·rstd·w + b``, which may cancel)."""
    ct = _support.compute_dtype(x)
    _, mean, rstd = layer_norm_reference(x, weight, bias, return_stats=True)
    scale = ((x.to(ct).abs() + mean.abs()[..., None]) * rstd[..., None]
             * weight.to(ct).abs() + bias.to(ct).abs())
    return _ratio(got, want, scale)


def layer_norm_bwd_mismatch(x, weight, mean, rstd, g, got, want) -> float:
    """How far the backward's ``got = (dx, dw, db)`` lies from ``want``
    (the plain version's from the same inputs), each output at its own
    scale, as ``adamw.update_mismatch`` holds AdamW: dx at one ulp of its
    type plus 1e-5 of ``rstd·(|w·g| + |mean(w·g)| + |x̂·mean(w·g·x̂)|)``,
    dw at 1e-5 of ``Σ|g·x̂|`` and db at 1e-5 of ``Σ|g|`` (fp32 sums over
    the rows, in another order). 1 or less means they agree; a dw
    without x̂, a db left out or a dx without its mean(w·g) term miss by
    far more."""
    ct = _support.compute_dtype(x)
    h = x.shape[-1]
    r = rstd.to(ct)[..., None]
    xhat = (x.to(ct) - mean.to(ct)[..., None]) * r
    gf = g.to(ct)
    wg = gf * weight.to(ct)
    c1 = wg.mean(dim=-1, keepdim=True)
    c2 = (wg * xhat).mean(dim=-1, keepdim=True)
    scales = (r * (wg.abs() + c1.abs() + (xhat * c2).abs()),
              (gf * xhat).abs().reshape(-1, h).sum(dim=0),
              gf.abs().reshape(-1, h).sum(dim=0))
    return max(_ratio(a, b, s) for a, b, s in zip(got, want, scales,
                                                  strict=True))


@functools.cache
def _ln_entry():
    fn = _support.library(_LN_NAME).ptt_layer_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _ln_bwd_entry():
    fn = _support.library(_LN_BWD_NAME).ptt_layer_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_params(x, weight, bias):
    _check_weight(x, weight)
    if bias.shape != weight.shape or bias.dtype != x.dtype \
            or bias.device != x.device:
        raise ValueError(f"layer_norm: bias {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device} does not match "
                         f"x [..., {x.shape[-1]}] {x.dtype} on {x.device}")


def _ln_fwd_kernel(x, weight, bias, epsilon):
    """The forward kernel: ``(y, mean, rstd)``, the statistics
    ``[x.shape[:-1]]`` fp32."""
    _check_params(x, weight, bias)
    code = _support.dtype_code(x)
    h = x.shape[-1]
    xc, wc, bc = x.contiguous(), weight.contiguous(), bias.contiguous()
    y = torch.empty_like(xc)
    mean = torch.empty(x.shape[:-1], device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    err = _ln_entry()(xc.data_ptr(), wc.data_ptr(), bc.data_ptr(),
                      y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                      xc.numel() // h, h, float(epsilon), code,
                      _support.stream_of(xc))
    _support.check(err, _LN_NAME)
    _support.LAUNCHES[_LN_NAME] += 1
    return y, mean, rstd


def _ln_bwd_kernel(x, weight, mean, rstd, g):
    """The backward kernel: ``(dx, dw [H] fp32, db [H] fp32)``."""
    _check_weight(x, weight)
    h = x.shape[-1]
    if h > MAX_H:
        raise ValueError(f"layer_norm backward kernel: H={h} > {MAX_H}")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"layer_norm backward: g {tuple(g.shape)} "
                         f"{g.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype}")
    for stat in (mean, rstd):
        if stat.dtype != torch.float32 or stat.numel() * h != x.numel():
            raise ValueError("layer_norm backward: mean and rstd must be "
                             "the forward's fp32 row statistics")
    code = _support.dtype_code(x)
    xc, gc, wc, mc, rc = (t.contiguous() for t in (x, g, weight, mean,
                                                   rstd))
    n = xc.numel() // h
    blocks = min(n, BWD_BLOCKS)
    dx = torch.empty_like(xc)
    part = torch.empty((2, blocks, h), device=x.device, dtype=torch.float32)
    dw = torch.empty((h,), device=x.device, dtype=torch.float32)
    db = torch.empty_like(dw)
    err = _ln_bwd_entry()(xc.data_ptr(), wc.data_ptr(), mc.data_ptr(),
                          rc.data_ptr(), gc.data_ptr(), dx.data_ptr(),
                          part[0].data_ptr(), part[1].data_ptr(),
                          dw.data_ptr(), db.data_ptr(), n, h, blocks, code,
                          _support.stream_of(xc))
    _support.check(err, _LN_BWD_NAME)
    _support.LAUNCHES[_LN_BWD_NAME] += 1
    return dx, dw, db


def layer_norm_bwd(x, weight, mean, rstd, g):
    """LayerNorm backward on its own: the kernel on CUDA tensors, the
    plain version on CPU tensors. Returns ``(dx, dw [H] fp32, db [H]
    fp32)``."""
    if _support.use_kernel(x):
        return _ln_bwd_kernel(x, weight, mean, rstd, g)
    return layer_norm_bwd_reference(x, weight, mean, rstd, g)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        ctx.kernel = _support.use_kernel(x)
        if ctx.kernel:
            y, mean, rstd = _ln_fwd_kernel(x, weight, bias, epsilon)
        else:
            y, mean, rstd = layer_norm_reference(x, weight, bias, epsilon,
                                                 return_stats=True)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, rstd = ctx.saved_tensors
        bwd = _ln_bwd_kernel if ctx.kernel else layer_norm_bwd_reference
        dx, dw, db = bwd(x, weight, mean, rstd, g)
        return dx, dw.to(weight.dtype), db.to(ctx.bias_dtype), None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape, any row
    count), differentiable in ``x``, ``weight`` and ``bias`` [H] (in the
    type of ``x``)."""
    return _LayerNorm.apply(x, weight, bias, float(epsilon))
