"""Decode attention over the stacked static KV cache, float layout: CUDA
kernel (``csrc/decode_attention.cu``) and its plain PyTorch version.

Replaces ``paddle_tpu/ops/pallas/decode_attention.py:211 raw_call``.
The kernel takes the WHOLE stacked ``[L, B, Hkv, S, D]`` buffers with
``layer`` and ``index`` as arguments and reads layer ``layer``,
positions ``[0, index)``, in place: no per-layer slice is copied (the
point of ``decode_attention.py:8-13``). The step's own k/v join the
softmax as well. ``index`` is one scalar for the batch; the per-slot
``[B]`` form comes with the serving engine.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["decode_attention", "decode_attention_reference"]

_NAME = "decode_attention"
HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8)


def decode_attention_reference(q, k_new, v_new, cache, layer: int,
                               index: int, *, scale=None):
    """Plain version, for any chunk length T: q [B, T, Hq, D] attends to
    cache positions ``[0, index)`` of layer ``layer`` plus the chunk's own
    k/v [B, Hkv, T, D] under a chunk-local causal mask — the visibility of
    writing the chunk first and masking ``j <= index + t``. fp32 scores
    and softmax over both pieces jointly; returns [B, T, Hq, D]."""
    B, T, Hq, D = q.shape
    Hkv = k_new.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kc = cache[0][layer, :, :, :index].float()         # [B, Hkv, index, D]
    vc = cache[1][layer, :, :, :index].float()
    qh = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, G, T, D)
    s_c = torch.einsum("bkgtd,bksd->bkgts", qh, kc) * scale
    s_n = torch.einsum("bkgtd,bkud->bkgtu", qh, k_new.float()) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s_n = s_n.masked_fill(~causal, float("-inf"))
    p = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    out = (torch.einsum("bkgts,bksd->bkgtd", p[..., :index], vc)
           + torch.einsum("bkgtu,bkud->bkgtd", p[..., index:],
                          v_new.float()))
    return out.reshape(B, Hq, T, D).permute(0, 2, 1, 3).to(q.dtype)


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_new, v_new, cache, layer: int, index: int, *,
                     scale=None):
    """One-token attention: q [B, 1, Hq, D], k_new/v_new [B, Hkv, 1, D],
    ``cache`` = (k_buf, v_buf) [L, B, Hkv, S, D]; the layer's cache holds
    tokens ``[0, index)``. Returns [B, 1, Hq, D]."""
    B, T, Hq, D = q.shape
    k_buf, v_buf = cache
    L, Bc, Hkv, S, Dc = k_buf.shape
    if T != 1 or k_new.shape != (B, Hkv, 1, D) or v_new.shape != \
            k_new.shape or Bc != B or Dc != D or v_buf.shape != \
            k_buf.shape or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k_new "
                         f"{tuple(k_new.shape)}, cache {tuple(k_buf.shape)}"
                         " do not fit [B,1,Hq,D] / [B,Hkv,1,D] / "
                         "[L,B,Hkv,S,D]")
    layer, index = int(layer), int(index)
    if not (0 <= layer < L and 0 <= index <= S):
        raise ValueError(f"decode_attention: layer {layer} of {L}, index "
                         f"{index} of {S} out of range")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not _support.use_kernel(q):
        return decode_attention_reference(q, k_new, v_new, cache, layer,
                                          index, scale=scale)
    if D not in HEAD_DIMS or Hq // Hkv not in GROUPS:
        raise ValueError(f"decode_attention kernel: head_dim {D} not in "
                         f"{HEAD_DIMS} or group {Hq // Hkv} not in {GROUPS}")
    code = _support.dtype_code(q)
    if any(t.dtype != q.dtype for t in (k_new, v_new, k_buf, v_buf)):
        raise TypeError("decode_attention: q, k/v and the cache must share "
                        "a dtype")
    if not (k_buf.is_contiguous() and v_buf.is_contiguous()):
        raise ValueError("decode_attention: cache buffers must be "
                         "contiguous (the kernel reads them in place)")
    qc, kn, vn = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    out = torch.empty_like(qc)
    err = _entry()(qc.data_ptr(), kn.data_ptr(), vn.data_ptr(),
                   k_buf.data_ptr(), v_buf.data_ptr(), out.data_ptr(), B,
                   Hq, Hkv, S, D, layer, index, float(scale), code,
                   _support.stream_of(qc))
    _support.check(err, _NAME)
    _support.LAUNCHES[_NAME] += 1
    return out
