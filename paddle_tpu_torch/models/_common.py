"""Pieces shared by the decoder-only families (Llama, GPT, Mamba): the
causal-LM loss with its head modes (``paddle_tpu/models/_common.py:10-28``)
and the static KV cache, float and int8 layouts (``:31-182``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels.decode_attention import (
    decode_attention_int8_reference, decode_attention_reference)
from paddle_tpu_torch.nn import functional as F

__all__ = ["causal_lm_loss", "cached_attention", "apply_cache_writes",
           "init_kv_cache", "stack_payloads"]


def causal_lm_loss(model, head_weight, input_ids, labels,
                   ignore_index: int = -100, **forward_kw):
    """Next-token loss of a decoder-only model. ``cfg.lm_head_mode !=
    "dense"`` fuses the head projection into the loss: the trunk's hidden
    states and the [E, V] ``head_weight`` (tied models pass
    ``embed.weight.T``) go to ``F.next_token_linear_loss`` over all T
    rows, so the [B, T, V] logits never exist. ``"dense"`` takes the
    model's logits ``[:, :-1]`` to fp32 against ``labels[:, 1:]`` in
    ``cross_entropy``. ``forward_kw`` (GPT's ``training`` and
    ``generator``) go to the trunk."""
    mode = model.config.lm_head_mode
    F.check_head_mode(mode)
    if mode != "dense":
        return F.next_token_linear_loss(
            model.hidden_states(input_ids, **forward_kw), head_weight,
            labels, ignore_index=ignore_index, mode=mode)
    logits = model(input_ids, **forward_kw)
    return F.cross_entropy(logits[:, :-1].float(), labels[:, 1:],
                           ignore_index=ignore_index)


def _quant_chunk(x):
    """Absmax int8 quantization of [B, Hkv, T, D] over D →
    ``(int8 [B, Hkv, T, D], fp32 scales [B, Hkv, T])``: scale = max|x| /
    127 (at least 1e-8), values rounded half to even and clipped to ±127
    (``paddle_tpu/models/_common.py:31-37``)."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    xq = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return xq.to(torch.int8), s


def cached_attention(q, k, v, cache, index, layer: int = 0):
    """Attention of a chunk q [B, T, Hq, D] (k/v [B, T, Hkv, D]) against
    the static cache. ``cache`` holds the FULL stacked read-only buffers
    ``(k_buf, v_buf)`` [L, B, Hkv, S, D] and ``layer`` is this block's
    layer id; the layer's cache holds positions ``[0, index)``. The chunk
    is not written here: it is returned as the payload
    ``(k [B, Hkv, T, D], v)`` in the cache's type, for
    ``apply_cache_writes`` after the forward.

    - prefill (``index`` 0 or None): causal attention over the raw chunk
      through the port's own ``scaled_dot_product_attention`` (the flash
      kernel on CUDA);
    - decode (T == 1): the decode kernel of the cache's layout, reading
      the stacked buffers in place;
    - a multi-token chunk at ``index > 0`` (chunked prefill, not on the
      ``generate`` path): the plain einsum version on CPU tensors (the JAX
      package's fallback arm). No kernel covers it yet, so on CUDA tensors
      it raises rather than run the plain version on the card.

    Returns ``(out [B, T, Hq, D], payload)``."""
    B, T, Hq, D = q.shape
    kt = k.transpose(1, 2)                              # [B, Hkv, T, D]
    vt = v.transpose(1, 2)
    if len(cache) == 4:
        (kq, ks), (vq, vs) = _quant_chunk(kt), _quant_chunk(vt)
        payload = (kq, vq, ks, vs)
    else:
        payload = (kt.to(cache[0].dtype), vt.to(cache[1].dtype))
    if not index:
        return F.scaled_dot_product_attention(q, k, v, causal=True), payload
    if T == 1:
        out = kernels.decode_attention.decode_attention(q, kt, vt, cache,
                                                        layer, index)
    elif kernels._support.use_kernel(q):
        raise NotImplementedError(
            f"cached_attention: a {T}-token chunk at index {index} (chunked "
            "prefill) has no CUDA kernel yet")
    else:
        plain = (decode_attention_int8_reference if len(cache) == 4
                 else decode_attention_reference)
        out = plain(q, kt, vt, cache, layer, index)
    return out, payload


def stack_payloads(payloads):
    """The per-layer payloads of ``cached_attention`` stacked leaf by leaf
    into ``[L, ...]`` tensors for ``apply_cache_writes``."""
    return tuple(torch.stack(leaf) for leaf in zip(*payloads))


def apply_cache_writes(cache, payload, index):
    """Write the stacked per-layer chunk payloads ([L, B, Hkv, T, D], and
    the int8 layout's scales [L, B, Hkv, T]) into the cache at positions
    ``[index, index + T)``. IN PLACE: the buffers
    of ``cache`` are modified (JAX returns new buffers; here the cache is
    one allocation for the whole generation). Returns ``cache``."""
    start = int(index or 0)
    for buf, x in zip(cache, payload):
        buf[:, :, :, start:start + x.shape[3]] = x.to(buf.dtype)
    return cache


def init_kv_cache(num_layers, batch_size, max_len, num_kv_heads, head_dim,
                  dtype, device):
    """``([L, B, Hkv, S, D], [L, B, Hkv, S, D])`` zeros on ``device``.
    Batch stays on axis 1 and heads ahead of sequence, as in the JAX
    package. ``dtype=torch.int8`` is the quantized layout ``(k_q, v_q,
    k_scale, v_scale)`` with fp32 per-(head, position) scales
    [L, B, Hkv, S]; any other integer type raises (it would truncate k/v
    on the write)."""
    shape = (num_layers, batch_size, num_kv_heads, max_len, head_dim)
    if dtype == torch.int8:
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    if not dtype.is_floating_point:
        raise ValueError(f"cache dtype {dtype} unsupported: use a float "
                         "dtype or torch.int8 (the quantized layout)")
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
