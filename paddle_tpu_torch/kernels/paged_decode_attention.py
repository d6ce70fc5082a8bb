"""Decode attention over the paged KV pool, one query token a slot at the
slot's own position: a CUDA kernel (``csrc/paged_decode_attention.cu``)
and its plain PyTorch version.

Replaces ``paddle_tpu/ops/pallas/paged_decode_attention.py:175 raw_call``,
both pool layouts, each with its own launch counter
(``paged_decode_attention``, ``paged_decode_attention_int8``): the float
pool ``(k, v)`` in q's type, and the int8 pool ``(k_q, v_q, k_scale,
v_scale)`` with fp32 per-position scales ``[N + 1, L, Hkv, P]`` folded
into the logits and the probabilities (``:140-158``), with the numerics of
the stacked int8 decode kernel. The pool is the serving engine's
(``models.generation.init_paged_cache``): leaves ``[N + 1, L, Hkv, P,
D]``, page 0 the null page. Slot ``b`` attends to its positions ``[0,
pos[b])`` — position ``p`` lies in page ``table[b, p // P]`` at offset
``p % P`` — and to its fresh k/v, under one softmax. The kernel reads the
pool in place through the page table (``:3-27``): no per-step gather.
``table`` [B, M] and ``pos`` [B] are int32 on the device, so a CUDA graph
that captures the launch replays it at the slots' current state.

The plain version is the gather the kernel removes followed by the
stacked decode's plain version (``paged_reference``, ``:237``): the
slots' pages gathered into a contiguous view, then
``decode_attention_reference`` (``decode_attention_int8_reference``
for the int8 pool) at each slot's own position.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.kernels.decode_attention import (
    GROUPS, HEAD_DIMS, decode_attention_int8_reference,
    decode_attention_reference)

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "gather_layer"]

_NAME = "paged_decode_attention"
_INT8_NAME = "paged_decode_attention_int8"


def gather_layer(pool, table, layer: int):
    """The slots' contiguous view of one layer: each pool leaf ``[N + 1,
    L, Hkv, P, *rest]`` gathered through ``table`` [B, M] into ``[1, B,
    Hkv, M·P, *rest]`` (a one-layer stacked cache)."""
    out = []
    for leaf in pool:
        g = leaf[:, layer][table.long()]            # [B, M, Hkv, P, *rest]
        g = g.transpose(1, 2)                       # [B, Hkv, M, P, *rest]
        s = g.shape
        out.append(g.reshape(s[0], s[1], s[2] * s[3], *s[4:])[None])
    return tuple(out)


def paged_decode_attention_reference(q, k_new, v_new, pool, table, pos,
                                     layer: int, *, scale=None):
    """Plain version: ``gather_layer`` then the stacked decode's plain
    version of the pool's layout at each slot's position ``pos`` [B].
    Shapes as ``paged_decode_attention``."""
    cache = gather_layer(pool, table, layer)
    plain = (decode_attention_int8_reference if len(pool) == 4
             else decode_attention_reference)
    return plain(q, k_new, v_new, cache, 0, pos, scale=scale)


@functools.cache
def _entry():
    fn = _support.library(_NAME).ptt_paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _int8_entry():
    fn = _support.library(_INT8_NAME).ptt_paged_decode_attention_int8
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, k_new, v_new, pool, table, pos, layer: int,
                           *, scale=None):
    """One-token attention of each slot over its pages: q [B, 1, Hq, D],
    k_new/v_new [B, Hkv, 1, D] (this step's k/v, not yet in the pool),
    ``pool`` the paged leaves ``(k, v)`` [N + 1, L, Hkv, P, D] in q's type,
    or the int8 layout's ``(k_q, v_q, k_scale, v_scale)`` (int8
    [N + 1, L, Hkv, P, D], fp32 [N + 1, L, Hkv, P]), ``table``
    [B, M] and ``pos`` [B] int32 page rows and fill positions, ``layer``
    this block's layer. Returns [B, 1, Hq, D]."""
    B, T, Hq, D = q.shape
    kp, vp = pool[:2]
    _, L, Hkv, P, Dp = kp.shape
    if (T != 1 or k_new.shape != (B, Hkv, 1, D) or v_new.shape !=
            k_new.shape or Dp != D or vp.shape != kp.shape or Hq % Hkv
            or table.ndim != 2 or table.shape[0] != B
            or pos.shape != (B,)):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, "
                         f"k_new {tuple(k_new.shape)}, pool "
                         f"{tuple(kp.shape)}, table {tuple(table.shape)}, "
                         f"pos {tuple(pos.shape)} do not fit [B,1,Hq,D] / "
                         "[B,Hkv,1,D] / [N+1,L,Hkv,P,D] / [B,M] / [B]")
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"paged_decode_attention: layer {layer} of {L}")
    if len(pool) == 4 and (kp.dtype != torch.int8 or vp.dtype != torch.int8
                           or any(t.shape != kp.shape[:4] or t.dtype !=
                                  torch.float32 for t in pool[2:])):
        raise ValueError("paged_decode_attention: the int8 pool is int8 "
                         "k/v [N+1,L,Hkv,P,D] and fp32 scales [N+1,L,Hkv,P]")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not _support.use_kernel(q):
        return paged_decode_attention_reference(q, k_new, v_new, pool,
                                                table, pos, layer,
                                                scale=scale)
    return _kernel(q, k_new, v_new, pool, table, pos, layer, scale)


def _kernel(q, k_new, v_new, pool, table, pos, layer, scale):
    """The launch of the pool layout's kernel (checked shapes and
    layer)."""
    B, _, Hq, D = q.shape
    quantized = len(pool) == 4
    kp, vp = pool[:2]
    _, L, Hkv, P, _ = kp.shape
    M = table.shape[1]
    if D not in HEAD_DIMS or Hq // Hkv not in GROUPS:
        raise ValueError(f"paged_decode_attention kernel: head_dim {D} not "
                         f"in {HEAD_DIMS} or group {Hq // Hkv} not in "
                         f"{GROUPS}")
    code = _support.dtype_code(q)
    if any(t.dtype != q.dtype for t in (k_new, v_new)) or (
            not quantized and any(t.dtype != q.dtype for t in (kp, vp))):
        raise TypeError("paged_decode_attention: q, k/v and the float pool "
                        "must share a dtype")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_decode_attention: table and pos are int32")
    if any(t.device != q.device for t in (*pool, table, pos)):
        raise ValueError("paged_decode_attention: pool, table and pos must "
                         "be on q's device")
    if not all(t.is_contiguous() for t in (*pool, table, pos)):
        raise ValueError("paged_decode_attention: pool, table and pos must "
                         "be contiguous (the kernel reads them in place)")
    qc, kn, vn = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    out = torch.empty_like(qc)
    head = (qc.data_ptr(), kn.data_ptr(), vn.data_ptr(), kp.data_ptr(),
            vp.data_ptr())
    tail = (table.data_ptr(), pos.data_ptr(), out.data_ptr(), B, Hq, Hkv,
            L, P, M, D, layer, float(scale), code, _support.stream_of(qc))
    if quantized:
        name = _INT8_NAME
        err = _int8_entry()(*head, pool[2].data_ptr(), pool[3].data_ptr(),
                            *tail)
    else:
        name = _NAME
        err = _entry()(*head, *tail)
    _support.check(err, name)
    _support.LAUNCHES[name] += 1
    return out
