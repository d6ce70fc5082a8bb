"""Decode attention over the stacked static KV cache, float and int8
layouts: CUDA kernels (``csrc/decode_attention.cu``) and their plain
PyTorch versions.

Replaces ``paddle_tpu/ops/pallas/decode_attention.py:211 raw_call``, both
layouts: the float cache ``(k, v)`` [L, B, Hkv, S, D] in q's type, and
the int8 cache ``(k_q, v_q, k_scale, v_scale)`` with fp32 per-position
scales [L, B, Hkv, S]. Each layout has its own launch counter
(``decode_attention``, ``decode_attention_int8``).
The kernel takes the WHOLE stacked ``[L, B, Hkv, S, D]`` buffers with
``layer`` and ``index`` as arguments and reads layer ``layer``,
positions ``[0, index)``, in place: no per-layer slice is copied (the
point of ``decode_attention.py:8-13``). The step's own k/v join the
softmax as well. ``index`` is one host int for the batch (``generate``),
or a device int32 ``[B]`` tensor of each row's own position (the serving
engine's batched step), which the kernel reads from device memory, so
that a CUDA graph replays it at the positions of the moment.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["decode_attention", "decode_attention_reference",
           "decode_attention_int8_reference"]

_NAME = "decode_attention"
_INT8_NAME = "decode_attention_int8"
LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8)


def _prefix(leaf, layer: int, index):
    """Layer ``layer`` of a stacked cache leaf ``[L, B, Hkv, S, ...]``
    as the positions attention reads, and their mask: for an int index
    the slice ``[0, index)`` and None; for a per-row ``[B]`` index every
    position and the ``[B, S]`` keep-mask ``s < index[b]``."""
    if isinstance(index, torch.Tensor):
        sl = leaf[layer]
        keep = (torch.arange(sl.shape[2], device=sl.device)[None, :]
                < index.to(sl.device).long()[:, None])
        return sl, keep
    return leaf[layer, :, :, :index], None


def _mask_prefix(s_c, keep):
    """Scores [B, Hkv, G, T, S] with the positions a row does not read
    at -inf."""
    if keep is None:
        return s_c
    return s_c.masked_fill(~keep[:, None, None, None, :], float("-inf"))


def decode_attention_reference(q, k_new, v_new, cache, layer: int,
                               index, *, scale=None):
    """Plain version, for any chunk length T: q [B, T, Hq, D] attends to
    cache positions ``[0, index)`` of layer ``layer`` (``index`` an int,
    or a ``[B]`` tensor of each row's own) plus the chunk's own k/v
    [B, Hkv, T, D] under a chunk-local causal mask — the visibility of
    writing the chunk first and masking ``j <= index + t``. fp32 scores
    and softmax over both pieces jointly; returns [B, T, Hq, D]."""
    B, T, Hq, D = q.shape
    Hkv = k_new.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kc, keep = _prefix(cache[0], layer, index)       # [B, Hkv, S', D]
    kc = kc.float()
    vc = _prefix(cache[1], layer, index)[0].float()
    S = kc.shape[2]
    qh = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, G, T, D)
    s_c = _mask_prefix(torch.einsum("bkgtd,bksd->bkgts", qh, kc) * scale,
                       keep)
    s_n = torch.einsum("bkgtd,bkud->bkgtu", qh, k_new.float()) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s_n = s_n.masked_fill(~causal, float("-inf"))
    p = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    out = (torch.einsum("bkgts,bksd->bkgtd", p[..., :S], vc)
           + torch.einsum("bkgtu,bkud->bkgtd", p[..., S:],
                          v_new.float()))
    return out.reshape(B, Hq, T, D).permute(0, 2, 1, 3).to(q.dtype)


def decode_attention_int8_reference(q, k_new, v_new, cache, layer: int,
                                    index, *, scale=None):
    """Plain version of the int8 layout, for any chunk length T, with the
    Pallas kernel's numerics (``decode_attention.py:134-172``): the int8
    k and v exactly in fp32, each position's k scale folded into its fp32
    logit, the cache positions' probabilities times their v scale rounded
    to q's type before the product with v (the softmax's sum takes them
    unrounded); the chunk's own k/v attend raw under the chunk-local
    causal mask. The softmax runs in log2 units against the largest logit
    rounded up to an integer, so that a probability's rounding does not
    depend on which maximum it is taken against (the kernel's running
    maxima differ from it by powers of two). Returns [B, T, Hq, D]."""
    B, T, Hq, D = q.shape
    Hkv = k_new.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k_q, v_q, k_s, v_s = cache
    kc, keep = _prefix(k_q, layer, index)             # [B, Hkv, S', D]
    kc = kc.float()
    vc = _prefix(v_q, layer, index)[0].float()
    ks = _prefix(k_s, layer, index)[0].float()[:, :, None, None]
    vs = _prefix(v_s, layer, index)[0].float()[:, :, None, None]
    qh = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, G, T, D) * (
        scale * LOG2E)
    s_c = _mask_prefix(torch.einsum("bkgtd,bksd->bkgts", qh, kc) * ks,
                       keep)
    s_n = torch.einsum("bkgtd,bkud->bkgtu", qh, k_new.float())
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s_n = s_n.masked_fill(~causal, float("-inf"))
    anchor = torch.cat([s_c, s_n], dim=-1).amax(-1, keepdim=True).ceil()
    p_c, p_n = torch.exp2(s_c - anchor), torch.exp2(s_n - anchor)
    den = p_c.sum(-1, keepdim=True) + p_n.sum(-1, keepdim=True)
    out = (torch.einsum("bkgts,bksd->bkgtd",
                        (p_c * vs).to(q.dtype).float(), vc)
           + torch.einsum("bkgtu,bkud->bkgtd", p_n, v_new.float())) / den
    return out.reshape(B, Hq, T, D).permute(0, 2, 1, 3).to(q.dtype)


@functools.cache
def _int8_entry():
    fn = _support.library(_INT8_NAME).ptt_decode_attention_int8
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_new, v_new, cache, layer: int, index, *,
                     scale=None):
    """One-token attention: q [B, 1, Hq, D], k_new/v_new [B, Hkv, 1, D],
    ``cache`` = (k_buf, v_buf) [L, B, Hkv, S, D] in q's type, or the int8
    layout (k_q, v_q [L, B, Hkv, S, D] int8, k_scale, v_scale
    [L, B, Hkv, S] fp32); the layer's cache holds tokens ``[0, index)``,
    ``index`` an int for the batch or an int32 ``[B]`` tensor on q's
    device (each row's own fill, clamped to ``[0, S]`` by the kernel).
    Returns [B, 1, Hq, D]."""
    B, T, Hq, D = q.shape
    quantized = len(cache) == 4
    k_buf, v_buf = cache[:2]
    L, Bc, Hkv, S, Dc = k_buf.shape
    if T != 1 or k_new.shape != (B, Hkv, 1, D) or v_new.shape != \
            k_new.shape or Bc != B or Dc != D or v_buf.shape != \
            k_buf.shape or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k_new "
                         f"{tuple(k_new.shape)}, cache {tuple(k_buf.shape)}"
                         " do not fit [B,1,Hq,D] / [B,Hkv,1,D] / "
                         "[L,B,Hkv,S,D]")
    layer = int(layer)
    if isinstance(index, torch.Tensor):
        if index.shape != (B,) or index.dtype != torch.int32 or \
                index.device != q.device:
            raise ValueError(f"decode_attention: a per-row index is int32 "
                             f"[{B}] on {q.device}, got {index.dtype} "
                             f"{tuple(index.shape)} on {index.device}")
    else:
        index = int(index)
        if not 0 <= index <= S:
            raise ValueError(f"decode_attention: index {index} of {S} out "
                             "of range")
    if not 0 <= layer < L:
        raise ValueError(f"decode_attention: layer {layer} of {L} out of "
                         "range")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if quantized and (k_buf.dtype != torch.int8 or v_buf.dtype != torch.int8
                      or any(t.shape != k_buf.shape[:4] or t.dtype !=
                             torch.float32 for t in cache[2:])):
        raise ValueError("decode_attention: the int8 layout is int8 k/v "
                         "[L,B,Hkv,S,D] and fp32 scales [L,B,Hkv,S]")
    if not _support.use_kernel(q):
        plain = (decode_attention_int8_reference if quantized
                 else decode_attention_reference)
        return plain(q, k_new, v_new, cache, layer, index, scale=scale)
    return _kernel(q, k_new, v_new, cache, layer, index, scale)


def _kernel(q, k_new, v_new, cache, layer, index, scale):
    """The launch of the layout's kernel (checked shapes and range)."""
    B, _, Hq, D = q.shape
    quantized = len(cache) == 4
    k_buf, v_buf = cache[:2]
    Hkv, S = k_buf.shape[2], k_buf.shape[3]
    if D not in HEAD_DIMS or Hq // Hkv not in GROUPS:
        raise ValueError(f"decode_attention kernel: head_dim {D} not in "
                         f"{HEAD_DIMS} or group {Hq // Hkv} not in {GROUPS}")
    code = _support.dtype_code(q)
    if any(t.dtype != q.dtype for t in (k_new, v_new)) or (
            not quantized and any(t.dtype != q.dtype
                                  for t in (k_buf, v_buf))):
        raise TypeError("decode_attention: q, k/v and the float cache must "
                        "share a dtype")
    if not all(t.is_contiguous() for t in cache):
        raise ValueError("decode_attention: cache buffers must be "
                         "contiguous (the kernel reads them in place)")
    qc, kn, vn = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    out = torch.empty_like(qc)
    per_row = isinstance(index, torch.Tensor)
    if per_row:
        index = index.contiguous()
    head = (qc.data_ptr(), kn.data_ptr(), vn.data_ptr(), k_buf.data_ptr(),
            v_buf.data_ptr())
    rows = (index.data_ptr() if per_row else None, out.data_ptr())
    tail = (B, Hq, Hkv, S, D, layer, 0 if per_row else index, float(scale),
            code, _support.stream_of(qc))
    if quantized:
        name = _INT8_NAME
        err = _int8_entry()(*head, cache[2].data_ptr(), cache[3].data_ptr(),
                            *rows, *tail)
    else:
        name = _NAME
        err = _entry()(*head, *rows, *tail)
    _support.check(err, name)
    _support.LAUNCHES[name] += 1
    return out
