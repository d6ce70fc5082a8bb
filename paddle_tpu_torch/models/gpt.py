"""GPT-3 family (pre-LN, learned positions, GELU MLP) — the port of
``paddle_tpu/models/gpt.py:27-195`` for serving and training.

Layers are an ``nn.ModuleList`` of blocks (the JAX package scans one
stacked block; ``bridge.py`` unstacks its weights). Every LayerNorm runs
the layer_norm kernels, attention the causal flash kernel (prefill,
training) or the decode kernel (one token against the stacked cache).
With ``cfg.remat`` and gradients enabled each block recomputes its
forward in backward, keeping what ``cfg.remat_policy`` saves
(``nn/scan.py``); the blocks tag the ``attn_out``, ``mlp_up`` and
``mlp_out`` products, as the JAX block names them. Dropout
(``cfg.dropout``, 0 in the published configurations) draws from the
generator the caller passes, and is replayed in recompute.

``pipeline_parts`` (the 1F1B decomposition) waits for the port's
pipeline schedule (ROADMAP Queue A6).
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
from paddle_tpu_torch.nn.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.norm import LayerNorm
from paddle_tpu_torch.nn.scan import run_blocks, tag

__all__ = ["GPTConfig", "GPTBlock", "GPTForCausalLM"]


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304            # 50257 padded to a multiple of 128
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    max_seq_len: int = 2048
    dropout: float = 0.0
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    init_std: float = 0.02
    # LM-head loss path — see LlamaConfig.lm_head_mode
    lm_head_mode: str = "dense"

    @classmethod
    def gpt3_6_7b(cls) -> "GPTConfig":
        return cls(hidden_size=4096, num_layers=32, num_heads=32)

    @classmethod
    def gpt3_1_3b(cls) -> "GPTConfig":
        return cls(hidden_size=2048, num_layers=24, num_heads=16)

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        base = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=128, dtype="float32",
                    remat=False)
        base.update(kw)
        return cls(**base)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        """Exact parameter count (embed + positions + blocks + head)."""
        E, L = self.hidden_size, self.num_layers
        per_layer = (3 * E * E + 3 * E      # wqkv w + b
                     + E * E + E            # wo
                     + 4 * E * E + 4 * E    # fc1
                     + 4 * E * E + E        # fc2
                     + 4 * E)               # 2 LayerNorms (w + b)
        return (self.vocab_size * E + self.max_seq_len * E
                + L * per_layer + 2 * E     # final LN
                + E * self.vocab_size)      # untied lm_head


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device, dtype, generator):
        super().__init__()
        E = cfg.hidden_size
        std = cfg.init_std
        out_std = cfg.init_std / math.sqrt(2 * cfg.num_layers)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln1 = LayerNorm(E, device=device, dtype=dtype)
        self.wqkv = Linear(E, 3 * E, std=std, **kw)
        self.wo = Linear(E, E, std=out_std, **kw)
        self.ln2 = LayerNorm(E, device=device, dtype=dtype)
        self.fc1 = Linear(E, 4 * E, std=std, **kw)
        self.fc2 = Linear(4 * E, E, std=out_std, **kw)
        self.drop = Dropout(cfg.dropout)
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.head_dim

    def forward(self, x, cache=None, index=None, layer: int = 0, *,
                training: bool = False,
                generator: torch.Generator | None = None):
        """With ``cache`` (the stacked [L, B, H, S, D] buffers, read only)
        returns ``(x, payload)`` — see ``_common.cached_attention``."""
        B, T, E = x.shape
        h = self.ln1(x)
        qkv = self.wqkv(h).reshape(B, T, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        payload = None
        if cache is not None:
            a, payload = cached_attention(q, k, v, cache, index, layer=layer)
        else:
            a = F.scaled_dot_product_attention(q, k, v, causal=True)
        with tag("attn_out"):
            attn_out = self.wo(a.reshape(B, T, E))
        x = x + self.drop(attn_out, training, generator)
        h = self.ln2(x)
        with tag("mlp_up"):
            up = F.gelu(self.fc1(h), approximate=True)
        with tag("mlp_out"):
            h = self.fc2(up)
        x = x + self.drop(h, training, generator)
        return x if cache is None else (x, payload)


class GPTForCausalLM(nn.Module):
    """Decoder-only causal LM. ``model(ids)`` returns logits [B, T, V].

    ``device=None`` builds on the current CUDA device and raises without
    one; pass ``device="cpu"`` for the host. ``dtype=None`` takes
    ``cfg.dtype``. Weights are drawn from ``generator`` (else a generator
    on ``device`` seeded with 0)."""

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype_of(dtype or cfg.dtype)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(device=device, dtype=dtype)
        E = cfg.hidden_size
        self.embed = Embedding(cfg.vocab_size, E, std=cfg.init_std,
                               generator=generator, **kw)
        self.pos_embed = Embedding(cfg.max_seq_len, E, std=cfg.init_std,
                                   generator=generator, **kw)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(
            GPTBlock(cfg, generator=generator, **kw)
            for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(E, **kw)
        self.lm_head = Linear(E, cfg.vocab_size, bias=False,
                              std=cfg.init_std, generator=generator, **kw)
        self.config = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.weight.dtype

    def _embed(self, input_ids, index=0):
        steps = torch.arange(input_ids.shape[1], device=self.device)
        positions = (index.long()[:, None] + steps
                     if isinstance(index, torch.Tensor)
                     else steps + int(index or 0))
        return self.embed(input_ids) + self.pos_embed(positions)

    def hidden_states(self, input_ids, training: bool = False,
                      generator: torch.Generator | None = None):
        """Trunk (embeddings → blocks → final LayerNorm) without the head.
        ``training`` turns dropout on (drawn from ``generator``)."""
        cfg = self.config
        x = self.drop(self._embed(input_ids), training, generator)
        x = run_blocks(self.blocks, x, remat=cfg.remat,
                       policy=cfg.remat_policy, training=training,
                       generator=generator)
        return self.ln_f(x)

    def forward(self, input_ids, training: bool = False,
                generator: torch.Generator | None = None):
        return self.lm_head(self.hidden_states(input_ids, training,
                                               generator))

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        """Stacked static KV cache ([L, B, H, S, D], same) of zeros on the
        model's device, in ``dtype`` (default: the model's type;
        ``torch.int8``: the quantized 4-leaf layout, see
        ``_common.init_kv_cache``). Raises past ``max_seq_len``:
        learned positions cannot extrapolate
        (``paddle_tpu/models/gpt.py:156-172``)."""
        cfg = self.config
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"decode length {max_len} exceeds max_seq_len="
                f"{cfg.max_seq_len} (learned positional embeddings cannot "
                "extrapolate)")
        return init_kv_cache(cfg.num_layers, batch_size, max_len,
                             cfg.num_heads, cfg.head_dim,
                             dtype_of(dtype or self.dtype), self.device)

    @torch.no_grad()
    def forward_with_cache(self, input_ids, cache, index):
        """Prefill (the prompt at index 0) or decode (one token at index
        t); positions are offset by ``index``. After the last block ONE
        stacked write puts the chunk's k/v of all layers into the cache,
        in place. Returns (logits [B, T, V], cache)."""
        x = self._embed(input_ids, index)
        payloads = []
        for layer, block in enumerate(self.blocks):
            x, payload = block(x, cache=cache, index=index, layer=layer)
            payloads.append(payload)
        cache = apply_cache_writes(cache, stack_payloads(payloads), index)
        return self.lm_head(self.ln_f(x)), cache

    def generate(self, input_ids, max_new_tokens: int, **kwargs):
        """Autoregressive decode — see ``paddle_tpu_torch.models.
        generation``."""
        from paddle_tpu_torch.models.generation import generate
        return generate(self, input_ids, max_new_tokens, **kwargs)

    def loss(self, input_ids, labels, ignore_index: int = -100,
             training: bool = True,
             generator: torch.Generator | None = None):
        """Next-token cross entropy through ``cfg.lm_head_mode`` — see
        ``_common.causal_lm_loss``; dropout (when ``cfg.dropout`` > 0)
        draws from ``generator``."""
        return causal_lm_loss(self, self.lm_head.weight, input_ids, labels,
                              ignore_index, training=training,
                              generator=generator)
