"""Flash attention forward (causal or not, GQA): CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py:128 _fwd``. Layout
[B, T, H, D] in and out; q-head h reads kv-head ``h // (Hq // Hkv)``;
causal rows see keys ``j <= i + Tk - Tq``. The backward kernels (rows 2
and 3 of the port's kernel table) come with the training slice;
``return_lse=True`` already hands out the row log-sum-exp they need.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["flash_attention", "flash_attention_reference"]

_NAME = "flash_attention"
HEAD_DIMS = (64, 128, 256)


def flash_attention_reference(q, k, v, *, causal: bool = True, scale=None,
                              return_lse: bool = False):
    """Plain version: full [Tq, Tk] scores in fp32, softmax, PV, cast."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    G = Hq // Hkv
    qf = q.float().reshape(B, Tq, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if causal:
        i = torch.arange(Tq, device=q.device)[:, None]
        j = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(j > i + (Tk - Tq), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                    # [B, Hkv, G, Tq]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(B, Tq, Hq, D).to(q.dtype)
    if return_lse:
        return o, lse.reshape(B, Hq, Tq)
    return o


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    return_lse: bool = False):
    """Attention over q [B, Tq, Hq, D], k/v [B, Tk, Hkv, D]; returns o
    [B, Tq, Hq, D] (and lse [B, Hq, Tq] fp32 with ``return_lse``)."""
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
    if not _support.use_kernel(q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         scale=scale, return_lse=return_lse)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    code = _support.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(qc)
    lse = (torch.empty((B, Hq, Tq), device=q.device, dtype=torch.float32)
           if return_lse else None)
    err = _entry()(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                   o.data_ptr(), None if lse is None else lse.data_ptr(),
                   B, Tq, Tk, Hq, Hkv, D, float(scale), int(bool(causal)),
                   code, _support.stream_of(qc))
    _support.check(err, _NAME)
    _support.LAUNCHES[_NAME] += 1
    return (o, lse) if return_lse else o
