"""Llama-2 family (RMSNorm + RoPE + GQA + SwiGLU) — the port of
``paddle_tpu/models/llama.py`` for serving and training.

Layers are an ``nn.ModuleList`` of blocks (the JAX package scans one
stacked block; ``bridge.py`` unstacks its weights). With ``cfg.remat``
and gradients enabled, each block recomputes its forward in backward,
keeping what ``cfg.remat_policy`` saves (``nn/scan.py``); the blocks tag
the projections the named policies save, as the JAX blocks do
(``qkv``, ``attn_out``, ``mlp_up``, ``mlp_gate``, ``mlp_out``). Weights
are ``[in, out]`` as in the JAX package (see
``nn/common.py``). The model is built directly on its device in its
dtype from the caller's generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.device import dtype_of, make_generator, resolve_device
from paddle_tpu_torch.models._common import (apply_cache_writes,
                                             cached_attention,
                                             causal_lm_loss, init_kv_cache,
                                             stack_payloads)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common import Embedding, Linear
from paddle_tpu_torch.nn.norm import RMSNorm
from paddle_tpu_torch.nn.scan import run_blocks, tag

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaForCausalLM"]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 4096
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    # LM-head loss path (nn.functional.linear_cross_entropy): "dense"
    # (logits + cross entropy), "fused" (the vocab-tiled kernels, logits
    # never stored), "chunked" (plain vocab chunks) or "auto"
    lm_head_mode: str = "dense"
    init_std: float = 0.02

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama2_70b(cls) -> "LlamaConfig":
        return cls(hidden_size=8192, intermediate_size=28672, num_layers=80,
                   num_heads=64, num_kv_heads=8)

    @classmethod
    def tiny(cls, vocab_size: int = 256, hidden_size: int = 64,
             num_layers: int = 2, num_heads: int = 4, num_kv_heads: int = 2,
             max_seq_len: int = 128, **kw) -> "LlamaConfig":
        return cls(vocab_size=vocab_size, hidden_size=hidden_size,
                   intermediate_size=hidden_size * 4 * 2 // 3 // 8 * 8 or 32,
                   num_layers=num_layers, num_heads=num_heads,
                   num_kv_heads=num_kv_heads, max_seq_len=max_seq_len,
                   dtype="float32", remat=False, **kw)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        E, F_, V, L = (self.hidden_size, self.intermediate_size,
                       self.vocab_size, self.num_layers)
        kv = self.num_kv_heads * self.head_dim
        per_layer = E * E + 2 * E * kv + E * E + 3 * E * F_ + 2 * E
        return V * E + L * per_layer + E + (0 if self.tie_embeddings
                                            else E * V)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        E = cfg.hidden_size
        kv_dim = cfg.num_kv_heads * cfg.head_dim
        std = cfg.init_std
        out_std = cfg.init_std / math.sqrt(2 * cfg.num_layers)
        kw = dict(bias=False, device=device, dtype=dtype,
                  generator=generator)
        self.wq = Linear(E, E, std=std, **kw)
        self.wk = Linear(E, kv_dim, std=std, **kw)
        self.wv = Linear(E, kv_dim, std=std, **kw)
        self.wo = Linear(E, E, std=out_std, **kw)
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.head_dim

    def forward(self, x, rope, cache=None, index=None, layer: int = 0):
        """``rope`` = (cos, sin) [T, D/2] tables for this chunk's positions,
        computed once per model forward. With ``cache`` returns
        ``(out, payload)`` — see ``_common.cached_attention``."""
        B, T, E = x.shape
        with tag("qkv"):
            q = self.wq(x).reshape(B, T, self.num_heads, self.head_dim)
            k = self.wk(x).reshape(B, T, self.num_kv_heads, self.head_dim)
            v = self.wv(x).reshape(B, T, self.num_kv_heads, self.head_dim)
        cos, sin = rope
        q = F.apply_rotary(q, cos, sin)
        k = F.apply_rotary(k, cos, sin)
        if cache is not None:
            out, payload = cached_attention(q, k, v, cache, index,
                                            layer=layer)
            return self.wo(out.reshape(B, T, E)), payload
        out = F.scaled_dot_product_attention(q, k, v, causal=True)
        with tag("attn_out"):
            return self.wo(out.reshape(B, T, E))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        E, F_ = cfg.hidden_size, cfg.intermediate_size
        kw = dict(bias=False, device=device, dtype=dtype,
                  generator=generator)
        self.gate = Linear(E, F_, std=cfg.init_std, **kw)
        self.up = Linear(E, F_, std=cfg.init_std, **kw)
        self.down = Linear(F_, E, std=cfg.init_std / math.sqrt(
            2 * cfg.num_layers), **kw)

    def forward(self, x):
        with tag("mlp_up"):
            up = self.up(x)
        with tag("mlp_gate"):
            gate = self.gate(x)
        act = F.swiglu(up, gate)
        with tag("mlp_out"):
            return self.down(act)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_eps, **kw)
        self.attn = LlamaAttention(cfg, generator=generator, **kw)
        self.mlp_norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_eps, **kw)
        self.mlp = LlamaMLP(cfg, generator=generator, **kw)

    def forward(self, x, rope, cache=None, index=None, layer: int = 0):
        attn_out = self.attn(self.attn_norm(x), rope=rope, cache=cache,
                             index=index, layer=layer)
        payload = None
        if cache is not None:
            attn_out, payload = attn_out
        x = x + attn_out
        x = x + self.mlp(self.mlp_norm(x))
        return x if cache is None else (x, payload)


class LlamaForCausalLM(nn.Module):
    """Decoder-only causal LM. ``model(ids)`` returns logits [B, T, V].

    ``device=None`` builds on the current CUDA device and raises without
    one; pass ``device="cpu"`` for the host. ``dtype=None`` takes
    ``cfg.dtype``. Weights are drawn from ``generator`` (else a generator
    on ``device`` seeded with 0)."""

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype_of(dtype or cfg.dtype)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(device=device, dtype=dtype)
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size,
                               std=cfg.init_std, generator=generator, **kw)
        self.blocks = nn.ModuleList(
            LlamaBlock(cfg, generator=generator, **kw)
            for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_eps, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                               std=cfg.init_std, generator=generator, **kw))
        self.config = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.weight.dtype

    def _rope(self, T: int, index):
        """(cos, sin) for positions ``arange(T) + index`` — once per
        forward, shared by every layer: [T, D/2] for an int index, [B, T,
        D/2] gathered on the device for a per-slot ``[B]`` index."""
        steps = torch.arange(T, device=self.device)
        positions = (index.long()[:, None] + steps
                     if isinstance(index, torch.Tensor)
                     else steps + int(index or 0))
        return F.rotary_embedding(positions, self.config.head_dim,
                                  self.config.rope_base)

    def _head(self, x):
        if self.lm_head is not None:
            return self.lm_head(x)
        return x @ self.embed.weight.T

    def hidden_states(self, input_ids, training: bool = False):
        """Trunk (embed → blocks → final norm) without the head. Under
        ``cfg.remat`` with gradients enabled, each block recomputes its
        forward in backward. Llama has no dropout: ``training`` is taken
        for the JAX package's signature (``paddle_tpu/models/llama.py:251``)
        and changes nothing."""
        cfg = self.config
        x = self.embed(input_ids)
        rope = self._rope(input_ids.shape[1], 0)
        x = run_blocks(self.blocks, x, rope, remat=cfg.remat,
                       policy=cfg.remat_policy)
        return self.norm(x)

    def forward(self, input_ids, training: bool = False):
        return self._head(self.hidden_states(input_ids, training))

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        """Stacked static KV cache ([L, B, Hkv, S, D], same) of zeros on
        the model's device, in ``dtype`` (default: the model's type;
        ``torch.int8``: the quantized 4-leaf layout, see
        ``_common.init_kv_cache``)."""
        cfg = self.config
        return init_kv_cache(cfg.num_layers, batch_size, max_len,
                             cfg.num_kv_heads, cfg.head_dim,
                             dtype_of(dtype or self.dtype), self.device)

    @torch.no_grad()
    def forward_with_cache(self, input_ids, cache, index):
        """Forward a chunk (prefill: the prompt at index 0; decode: one
        token at index t; a later chunk of a prompt at its offset). Every
        block reads the stacked cache through its layer id; after the last
        block ONE stacked write puts the chunk's k/v of all layers at
        ``[index, index + T)`` — in place (see
        ``_common.apply_cache_writes``). The serving engine's batched step
        passes one token a slot with ``index`` an int32 ``[B]`` tensor of
        the slots' positions, over the stacked cache or a
        ``_common.PagedKV`` (the ``jax.vmap`` of this method in
        ``paddle_tpu/serving/engine.py:860-888``). Returns (logits
        [B, T, V], cache)."""
        x = self.embed(input_ids)
        rope = self._rope(input_ids.shape[1], index)
        payloads = []
        for layer, block in enumerate(self.blocks):
            x, payload = block(x, rope=rope, cache=cache, index=index,
                              layer=layer)
            payloads.append(payload)
        cache = apply_cache_writes(cache, stack_payloads(payloads), index)
        return self._head(self.norm(x)), cache

    def loss(self, input_ids, labels, ignore_index: int = -100,
             training: bool = True,
             generator: torch.Generator | None = None):
        """Next-token cross entropy (labels equal to the inputs for LM
        training on packed sequences, positions at ``ignore_index``
        skipped) through ``cfg.lm_head_mode`` — see
        ``_common.causal_lm_loss``. A tied model's head weight is the
        embedding table transposed. Llama has no dropout: ``training``
        goes to the trunk as in the JAX package, and ``generator`` is
        taken for the training step's call and not used."""
        weight = (self.lm_head.weight if self.lm_head is not None
                  else self.embed.weight.T)
        return causal_lm_loss(self, weight, input_ids, labels, ignore_index,
                              training=training)

    def generate(self, input_ids, max_new_tokens: int, **kwargs):
        """Autoregressive decode — see ``paddle_tpu_torch.models.
        generation``."""
        from paddle_tpu_torch.models.generation import generate
        return generate(self, input_ids, max_new_tokens, **kwargs)
