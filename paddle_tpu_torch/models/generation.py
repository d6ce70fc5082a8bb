"""Autoregressive generation (greedy / temperature / top-k / top-p) — the
port of ``paddle_tpu/models/generation.py:86 sample_logits`` and
``:403 generate``.

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
"""

from __future__ import annotations

import torch

__all__ = ["filter_logits", "sample_logits", "generate"]


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
