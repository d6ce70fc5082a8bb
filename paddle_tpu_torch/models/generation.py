"""Autoregressive generation (greedy / temperature / top-k / top-p) — the
port of ``paddle_tpu/models/generation.py:86 sample_logits`` and
``:403 generate`` — and the paged KV cache's pool and page-table layer
(``:126-179``: ``init_paged_cache``, ``paged_gather``,
``paged_scatter``), which the serving engine's paged mode runs on.

The JAX package compiles the whole loop (``lax.while_loop``); here the
loop is Python driving one prefill and single-token decode steps against
the fixed-shape cache, with the same early exit once every row has
emitted EOS. Works with any model exposing ``init_cache(B, S, dtype)`` and
``forward_with_cache(ids, cache, index)``.

Sampling is split into a deterministic filter (``filter_logits``:
temperature, top-k and top-p masks, comparable with the JAX package's)
and a draw from a ``torch.Generator``. Sampled streams cannot match the
JAX package's (threefry against Philox); they are deterministic per
generator seed.

The JAX engine splits a request's key once per emitted token, and
``advance_key`` (``:64``) replays that schedule for a resumed stream. The
port's counterpart is an offset: the serving engine draws token ``k`` of
a stream with seed ``s`` from the request's generator seeded with
``stream_seed(s, k)``, so ``advance_generator`` puts a generator at any
token of the stream at once.
"""

from __future__ import annotations

import torch

__all__ = ["filter_logits", "sample_logits", "generate", "stream_seed",
           "advance_generator", "init_paged_cache", "paged_gather",
           "paged_scatter"]

_SEED_MASK = (1 << 63) - 1


def stream_seed(seed: int, index: int) -> int:
    """The seed token ``index`` of a sampled stream with seed ``seed`` is
    drawn under (a 63-bit mix of the two, so that neighbouring seeds and
    tokens give unrelated streams)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(index) * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) & ((1 << 64) - 1)
    return (x ^ (x >> 29)) & _SEED_MASK


def advance_generator(generator: torch.Generator, seed: int,
                      steps: int) -> torch.Generator:
    """Position ``generator`` at token ``steps`` of the sampled stream
    with seed ``seed`` — the offset form of the JAX package's
    ``advance_key`` (``paddle_tpu/models/generation.py:64``): a resumed
    stream that already delivered ``steps`` tokens draws its next one
    as the uninterrupted stream would. Returns the generator."""
    if steps < 0:
        raise ValueError(f"advance_generator: steps {steps} < 0")
    generator.manual_seed(stream_seed(seed, steps))
    return generator


# ---------------------------------------------------------------------------
# Paged KV cache (``paddle_tpu/models/generation.py:111-179``): the pool
# and page-table layer of the cache contract. A model's ``init_cache(1,
# S)`` leaves ([L, 1, Hkv, S, D], scales [L, 1, Hkv, S] in the int8
# layout) become a pool of fixed-size pages plus a page table per
# sequence. Physical page 0 is the null page: unmapped table entries and
# masked (padding) writes land there, never on a live page. A gather of
# the pages holding positions [0, index) reproduces the contiguous buffer
# over those positions bit for bit.
# ---------------------------------------------------------------------------

def init_paged_cache(proto_cache, num_pages: int, page_tokens: int):
    """The page pool for a cache proto (``model.init_cache(1, S)``
    leaves): leaves ``[num_pages + 1, L, Hkv, page_tokens, *rest]`` of
    zeros on the proto's device, in its types. Page 0 is the null page;
    usable page ids are ``1 .. num_pages``."""
    pool = []
    for leaf in proto_cache:
        if leaf.ndim < 4 or leaf.shape[1] != 1:
            raise ValueError(
                f"cache leaf {tuple(leaf.shape)} is not the [L, 1, Hkv, S, "
                "...] layout init_kv_cache produces")
        L, _, Hkv = leaf.shape[:3]
        pool.append(torch.zeros((num_pages + 1, L, Hkv, page_tokens)
                                + tuple(leaf.shape[4:]), dtype=leaf.dtype,
                                device=leaf.device))
    return tuple(pool)


def paged_gather(pool, table):
    """A sequence's contiguous cache view from its page table (``table``
    [M] int ids; 0 the null page): leaves ``[L, 1, Hkv, M·P, *rest]``,
    position ``p`` read from ``pool[table[p // P]][..., p % P]``. A copy:
    writes to it do not reach the pool (``paged_scatter`` does that).
    Unmapped (null) regions hold garbage that attention masks."""
    out = []
    for leaf in pool:
        g = leaf[table.long()]                    # [M, L, Hkv, P, *rest]
        g = g.movedim(0, 2)                       # [L, Hkv, M, P, *rest]
        s = g.shape
        out.append(g.reshape(s[0], s[1], s[2] * s[3], *s[4:])[:, None])
    return tuple(out)


def paged_scatter(pool, table, chunk, index: int, page_tokens: int,
                  length: int | None = None):
    """Write a contiguous chunk (leaves ``[L, 1, Hkv, T, *rest]``, covering
    positions ``[index, index + T)``) into the pool through ``table``
    [M], IN PLACE (the JAX package returns new leaves). Positions at or
    past ``length`` (the chunk's true token count; the rest is padding)
    go to the null page, so a right-padded chunk never clobbers a live
    page. Returns ``pool``."""
    T = chunk[0].shape[3]
    j = torch.arange(T, device=table.device)
    pos = int(index) + j
    pages = table.long()[(pos // page_tokens).clamp(0, table.shape[0] - 1)]
    if length is not None:
        pages = torch.where(j < int(length), pages, 0)
    offs = pos % page_tokens
    for leaf, ch in zip(pool, chunk):
        leaf[pages, :, :, offs] = ch[:, 0].movedim(2, 0).to(leaf.dtype)
    return pool


def filter_logits(logits, *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """[B, V] logits → fp32 logits divided by ``temperature`` with the
    tokens outside top-k and outside the nucleus set to -inf (ties at the
    k-th value are kept, and the top-1 always stays)."""
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        threshold = torch.where(keep, sorted_logits,
                                torch.full_like(sorted_logits, float("inf"))
                                ).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def sample_logits(logits, generator: torch.Generator | None = None, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Next tokens [B] (int64) from [B, V] logits. ``temperature == 0`` or
    ``generator is None`` → greedy argmax (the first maximum, as
    ``jnp.argmax``); otherwise one draw per row from the filtered
    distribution."""
    if generator is None or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature=temperature,
                                        top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             eos_token_id: int | None = None, pad_token_id: int = 0,
             generator: torch.Generator | None = None, cache_dtype=None):
    """Decode ``max_new_tokens`` tokens after the prompt ``input_ids``
    [B, T0] (a tensor or array of ints).

    Returns [B, T0 + max_new_tokens] int64 on the model's device;
    positions after a row's EOS hold ``pad_token_id``. The loop stops as
    soon as every row has finished (the remaining positions already hold
    the pad). Sampling with ``temperature > 0`` and no ``generator`` draws
    from a generator seeded with 0. ``cache_dtype`` goes to the model's
    ``init_cache`` (``torch.int8``: the quantized KV cache of the
    attention families; Mamba keeps its float state)."""
    device = model.device
    input_ids = torch.as_tensor(input_ids, device=device).long()
    if max_new_tokens <= 0:
        return input_ids
    B, T0 = input_ids.shape
    S = T0 + int(max_new_tokens)
    cache = model.init_cache(B, S, dtype=cache_dtype)
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def pick(logits):
        return sample_logits(logits, None if temperature == 0.0 else
                             generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    logits, cache = model.forward_with_cache(input_ids, cache, 0)
    seq = torch.full((B, S), pad_token_id, dtype=torch.long, device=device)
    seq[:, :T0] = input_ids
    tok = pick(logits[:, -1])
    seq[:, T0] = tok
    finished = None
    if eos_token_id is not None:
        finished = tok == eos_token_id
    for i in range(1, int(max_new_tokens)):
        if finished is not None and bool(finished.all()):
            break
        logits, cache = model.forward_with_cache(tok[:, None], cache,
                                                 T0 + i - 1)
        tok = pick(logits[:, -1])
        if finished is not None:
            tok = torch.where(finished, torch.full_like(tok, pad_token_id),
                              tok)
            finished = finished | (tok == eos_token_id)
        seq[:, T0 + i] = tok
    return seq
