"""Pieces shared by the decoder-only families (Llama, GPT, Mamba): the
causal-LM loss with its head modes (``paddle_tpu/models/_common.py:10-28``)
and the static KV cache, float and int8 layouts (``:31-182``), with the
serving engine's two forms of it: the contiguous cache at a per-slot
``[B]`` index, and the paged pool (``PagedKV``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.nn import functional as F

__all__ = ["causal_lm_loss", "cached_attention", "apply_cache_writes",
           "einsum_chunk_attention", "init_kv_cache", "stack_payloads",
           "PagedKV"]


def causal_lm_loss(model, head_weight, input_ids, labels,
                   ignore_index: int = -100, **forward_kw):
    """Next-token loss of a decoder-only model. ``cfg.lm_head_mode !=
    "dense"`` fuses the head projection into the loss: the trunk's hidden
    states and the [E, V] ``head_weight`` (tied models pass
    ``embed.weight.T``) go to ``F.next_token_linear_loss`` over all T
    rows, so the [B, T, V] logits never exist. ``"dense"`` takes the
    model's logits ``[:, :-1]`` to fp32 against ``labels[:, 1:]`` in
    ``cross_entropy`` (at ``V <= 2048`` the softmax cross-entropy
    kernels). ``forward_kw`` (``training``, and GPT's and ERNIE's
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


class PagedKV:
    """The paged pool as ``forward_with_cache``'s cache, for the serving
    engine's batched decode step: ``pool`` the leaves ``[N + 1, L, Hkv, P,
    *rest]`` (``models.generation.init_paged_cache``; page 0 the null
    page), ``table`` the slots' page rows ``[B, M]`` int32 and ``active``
    ``[B]`` bool, the slots whose step is written back (the others write
    to the null page, ``paddle_tpu/serving/engine.py:956-961``). All on
    the device."""

    __slots__ = ("pool", "table", "active")

    def __init__(self, pool, table, active):
        self.pool, self.table, self.active = tuple(pool), table, active

    @property
    def page_tokens(self) -> int:
        return self.pool[0].shape[3]


def einsum_chunk_attention(q, kt, vt, cache, layer: int, index: int):
    """The JAX package's einsum arm of ``cached_attention``
    (``paddle_tpu/models/_common.py:118-141``) in torch ops: a chunk q
    [B, T, Hq, D] (its own k/v ``kt``/``vt`` [B, Hkv, T, D]) against
    layer ``layer`` of the stacked cache, whose positions ``[0, index)``
    it reads. Scores and products in q's type (the int8 cache dequantized
    to it, the scales too), the cache's positions from ``index`` on and
    the chunk's future masked with fp32's lowest value, one fp32 softmax
    over both pieces, probabilities cast back to q's type. It serves a
    multi-token chunk at ``index > 0`` (chunked prefill, a prefix-cache
    hit), where the JAX package runs no kernel either; on CUDA tensors it
    runs as torch ops on the card. Returns [B, T, Hq, D]."""
    B, T, Hq, D = q.shape
    Hkv = kt.shape[1]
    G = Hq // Hkv
    scale = 1.0 / D ** 0.5
    dt = q.dtype
    if len(cache) == 4:
        k_c, v_c, k_s, v_s = (c[layer] for c in cache)
        kc = k_c.to(dt) * k_s.to(dt)[..., None]
        vc = v_c.to(dt) * v_s.to(dt)[..., None]
    else:
        kc, vc = (c[layer].to(dt) for c in cache[:2])
    S = kc.shape[2]
    qh = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, T, D)
    neg = torch.finfo(torch.float32).min
    s_c = torch.einsum("bkgtd,bksd->bkgts", qh, kc) * scale
    keep_c = torch.arange(S, device=q.device) < index
    s_c = torch.where(keep_c, s_c.float(), neg)
    s_n = torch.einsum("bkgtd,bkud->bkgtu", qh, kt) * scale
    keep_n = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s_n = torch.where(keep_n, s_n.float(), neg)
    probs = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    p_c, p_n = probs[..., :S].to(dt), probs[..., S:].to(dt)
    out = (torch.einsum("bkgts,bksd->bkgtd", p_c, vc)
           + torch.einsum("bkgtu,bkud->bkgtd", p_n, vt))
    return out.reshape(B, Hq, T, D).permute(0, 2, 1, 3)


def cached_attention(q, k, v, cache, index, layer: int = 0):
    """Attention of a chunk q [B, T, Hq, D] (k/v [B, T, Hkv, D]) against
    the cache. ``cache`` holds the FULL stacked read-only buffers
    ``(k_buf, v_buf)`` [L, B, Hkv, S, D] (or the int8 layout's four
    leaves), or a ``PagedKV``, and ``layer`` is this block's layer id;
    the layer's cache holds positions ``[0, index)``, ``index`` an int
    for the batch or an int32 ``[B]`` tensor of each slot's own. The
    chunk is not written here: it is returned as the payload
    ``(k [B, Hkv, T, D], v)`` in the cache's type, for
    ``apply_cache_writes`` after the forward.

    - prefill (``index`` 0 or None): causal attention over the raw chunk
      through the port's own ``scaled_dot_product_attention`` (the flash
      kernel on CUDA);
    - decode (T == 1) against the stacked cache: the decode kernel of the
      cache's layout, reading the stacked buffers in place, at one index
      or at each slot's;
    - decode against a ``PagedKV``: the paged decode kernel, reading the
      slots' pages in place at each slot's index;
    - a multi-token chunk at ``index > 0`` (chunked prefill, a prefix-
      cache hit): ``einsum_chunk_attention``, the JAX package's einsum
      arm, which no kernel replaces there either.

    Returns ``(out [B, T, Hq, D], payload)``."""
    B, T, Hq, D = q.shape
    paged = isinstance(cache, PagedKV)
    leaves = cache.pool if paged else cache
    kt = k.transpose(1, 2)                              # [B, Hkv, T, D]
    vt = v.transpose(1, 2)
    if len(leaves) == 4:
        (kq, ks), (vq, vs) = _quant_chunk(kt), _quant_chunk(vt)
        payload = (kq, vq, ks, vs)
    else:
        payload = (kt.to(leaves[0].dtype), vt.to(leaves[1].dtype))
    per_slot = isinstance(index, torch.Tensor)
    if (paged or per_slot) and T != 1:
        raise ValueError(f"cached_attention: a {T}-token chunk takes one "
                         "int index over the stacked cache; a paged or "
                         "per-slot step is one token a slot")
    if paged:
        out = kernels.paged_decode_attention.paged_decode_attention(
            q, kt, vt, cache.pool, cache.table, index, layer)
    elif not per_slot and not index:
        out = F.scaled_dot_product_attention(q, k, v, causal=True)
    elif T == 1:
        out = kernels.decode_attention.decode_attention(q, kt, vt, cache,
                                                        layer, index)
    else:
        out = einsum_chunk_attention(q, kt, vt, cache, layer, int(index))
    return out, payload


def stack_payloads(payloads):
    """The per-layer payloads of ``cached_attention`` stacked leaf by leaf
    into ``[L, ...]`` tensors for ``apply_cache_writes``."""
    return tuple(torch.stack(leaf) for leaf in zip(*payloads))


def apply_cache_writes(cache, payload, index):
    """Write the stacked per-layer chunk payloads ([L, B, Hkv, T, D], and
    the int8 layout's scales [L, B, Hkv, T]) into the cache. IN PLACE:
    the buffers of ``cache`` are modified (JAX returns new buffers; here
    the cache is one allocation for the whole generation, or the
    engine's). Returns ``cache``.

    - an int ``index``: positions ``[index, index + T)`` of every row;
    - a ``[B]`` tensor (one token a slot): each slot's own position,
      clamped into the buffer as ``dynamic_update_slice`` clamps;
    - a ``PagedKV`` (one token a slot at ``index`` [B]): page
      ``table[b, index[b] // P]`` at offset ``index[b] % P``, and the
      null page for the inactive slots
      (``paddle_tpu/serving/engine.py:953-961``)."""
    if isinstance(cache, PagedKV):
        P, M = cache.page_tokens, cache.table.shape[1]
        pos = index.long()
        rows = torch.arange(pos.shape[0], device=pos.device)
        pages = cache.table[rows, (pos // P).clamp(0, M - 1)].long()
        pages = torch.where(cache.active, pages, 0)
        offs = pos % P
        for buf, x in zip(cache.pool, payload):
            buf[pages, :, :, offs] = x.select(3, 0).movedim(1, 0).to(
                buf.dtype)
        return cache
    if isinstance(index, torch.Tensor):
        for buf, x in zip(cache, payload):
            pos = index.long().clamp(0, buf.shape[3] - 1)
            rows = torch.arange(pos.shape[0], device=pos.device)
            buf[:, rows, :, pos] = x.select(3, 0).movedim(1, 0).to(
                buf.dtype)
        return cache
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
