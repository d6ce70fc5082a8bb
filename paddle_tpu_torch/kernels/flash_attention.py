"""Flash attention (causal or not, GQA), forward and backward: CUDA kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), their
plain PyTorch versions, and the autograd wiring.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py:128 _fwd``,
``:261 _bwd_impl`` (its dq kernel, call :282, and its dk/dv kernel, call
:308) and their custom VJP (``:349-370``). Layout [B, T, H, D] in and
out; q-head h reads kv-head ``h // (Hq // Hkv)``; causal rows see keys
``j <= i + Tk - Tq``. The forward saves the row log-sum-exp; the backward
recomputes the probabilities from it and takes ``delta = rowsum(dO·O)``
here, in torch ops, as the JAX package does outside its kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference"]

_NAME = "flash_attention"
_DQ_NAME = "flash_attention_bwd_dq"
_DKDV_NAME = "flash_attention_bwd_dkdv"
HEAD_DIMS = (64, 128, 256)


def _causal_mask(Tq, Tk, device):
    i = torch.arange(Tq, device=device)[:, None]
    j = torch.arange(Tk, device=device)[None, :]
    return j > i + (Tk - Tq)


def flash_attention_reference(q, k, v, *, causal: bool = True, scale=None,
                              return_lse: bool = False):
    """Plain version: full [Tq, Tk] scores in fp32, softmax, PV, cast."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    ct = _support.compute_dtype(q)
    G = Hq // Hkv
    qf = q.to(ct).reshape(B, Tq, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(ct)) * scale
    if causal:
        s = s.masked_fill(_causal_mask(Tq, Tk, q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                    # [B, Hkv, G, Tq]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(ct))
    o = o.reshape(B, Tq, Hq, D).to(q.dtype)
    if return_lse:
        return o, lse.reshape(B, Hq, Tq)
    return o


def flash_attention_bwd_reference(q, k, v, o, lse, do, *,
                                  causal: bool = True, scale=None):
    """Plain backward: ``(dq, dk, dv)`` from the forward's inputs, output
    and lse [B, Hq, Tq] and the output gradient ``do``. The kernels'
    arithmetic over full [Tq, Tk] arrays: P = exp(S - lse) and dS in fp32,
    both rounded to the input type before the products, dk/dv summed over
    each kv-head's group."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    ct = _support.compute_dtype(q)
    G = Hq // Hkv

    def rounded(t):
        return t.to(q.dtype).to(ct)

    qf = q.to(ct).reshape(B, Tq, Hkv, G, D)
    dof = do.to(ct).reshape(B, Tq, Hkv, G, D)
    kf, vf = k.to(ct), v.to(ct)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    if causal:
        s = s.masked_fill(_causal_mask(Tq, Tk, q.device), float("-inf"))
    p = torch.exp(s - lse.to(ct).reshape(B, Hkv, G, Tq)[..., None])
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dof,
                         o.to(ct).reshape(B, Tq, Hkv, G, D))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = rounded(p * (dp - delta[..., None]) * scale)
    dv = torch.einsum("bkgqs,bqkgd->bskd", rounded(p), dof)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, Tq, Hq, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entries():
    lib = _support.library(_DQ_NAME)
    dq = lib.ptt_flash_attention_bwd_dq
    dkdv = lib.ptt_flash_attention_bwd_dkdv
    dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dkdv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dq.restype = dkdv.restype = ctypes.c_int
    return dq, dkdv


def _check_kernel_inputs(q, k, v):
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    return _support.dtype_code(q)


def _fwd_kernel(q, k, v, causal, scale):
    """The forward kernel: ``(o, lse [B, Hq, Tq] fp32)``."""
    code = _check_kernel_inputs(q, k, v)
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(qc)
    lse = torch.empty((B, Hq, Tq), device=q.device, dtype=torch.float32)
    err = _entry()(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                   o.data_ptr(), lse.data_ptr(), B, Tq, Tk, Hq, Hkv, D,
                   float(scale), int(bool(causal)), code,
                   _support.stream_of(qc))
    _support.check(err, _NAME)
    _support.LAUNCHES[_NAME] += 1
    return o, lse


def _bwd_args(q, k, causal, scale, code, stream):
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    return (B, Tq, Tk, Hq, Hkv, D, float(scale), int(bool(causal)), code,
            stream)


def _dq_kernel(q, k, v, do, lse, delta, *, causal, scale):
    """The dq kernel on contiguous inputs (``delta`` = rowsum(dO·O) fp32
    [B, Hq, Tq])."""
    code = _check_kernel_inputs(q, k, v)
    dq = torch.empty_like(q)
    err = _bwd_entries()[0](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_bwd_args(q, k, causal, scale, code, _support.stream_of(q)))
    _support.check(err, _DQ_NAME)
    _support.LAUNCHES[_DQ_NAME] += 1
    return dq


def _dkdv_kernel(q, k, v, do, lse, delta, *, causal, scale):
    """The dk/dv kernel on contiguous inputs; dk, dv [B, Tk, Hkv, D]."""
    code = _check_kernel_inputs(q, k, v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _bwd_entries()[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_args(q, k, causal, scale, code, _support.stream_of(q)))
    _support.check(err, _DKDV_NAME)
    _support.LAUNCHES[_DKDV_NAME] += 1
    return dk, dv


def _bwd_kernels(q, k, v, o, lse, do, *, causal, scale):
    """delta in torch ops, then the dq and dk/dv kernels: ``(dq, dk,
    dv)``."""
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)} "
                         f"{do.dtype} does not match q {tuple(q.shape)} "
                         f"{q.dtype}")
    B, Tq, Hq, _ = q.shape
    if lse.shape != (B, Hq, Tq) or lse.dtype != torch.float32:
        raise ValueError("flash_attention backward: lse must be the "
                         "forward's fp32 [B, Hq, Tq]")
    qc, kc, vc, doc, lc = (t.contiguous() for t in (q, k, v, do, lse))
    delta = torch.einsum("bthd,bthd->bht", doc.float(),
                         o.float()).contiguous()
    kw = dict(causal=causal, scale=scale)
    dq = _dq_kernel(qc, kc, vc, doc, lc, delta, **kw)
    dk, dv = _dkdv_kernel(qc, kc, vc, doc, lc, delta, **kw)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale=None):
    """Attention backward on its own: the two kernels on CUDA tensors, the
    plain version on CPU tensors. Returns ``(dq, dk, dv)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    bwd = (_bwd_kernels if _support.use_kernel(q)
           else flash_attention_bwd_reference)
    return bwd(q, k, v, o, lse, do, causal=causal, scale=scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.kernel = _support.use_kernel(q)
        if ctx.kernel:
            o, lse = _fwd_kernel(q, k, v, causal, scale)
        else:
            o, lse = flash_attention_reference(q, k, v, causal=causal,
                                               scale=scale, return_lse=True)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _bwd_kernels if ctx.kernel else flash_attention_bwd_reference
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal,
                         scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    return_lse: bool = False):
    """Attention over q [B, Tq, Hq, D], k/v [B, Tk, Hkv, D]; returns o
    [B, Tq, Hq, D] (and lse [B, Hq, Tq] fp32 with ``return_lse``),
    differentiable in q, k and v."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "[B, T, H, D] with k and v alike")
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch, head_dim "
                         "or head grouping")
    if causal and Tq > Tk:
        raise ValueError(f"flash_attention: causal with Tq={Tq} > Tk={Tk} "
                         "leaves rows with no visible key")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return (o, lse) if return_lse else o
