"""ERNIE family: bidirectional post-LN encoder with the MLM and
sentence-order pretraining heads — the port of
``paddle_tpu/models/ernie.py:32-183``.

Layers are an ``nn.ModuleList`` of blocks (the JAX package scans one
stacked block under ``ernie.blocks.block``; ``bridge.py`` unstacks it).
Every LayerNorm runs the layer_norm kernels. Attention without an
``attention_mask`` runs the non-causal flash kernel; with one it runs
the masked einsum arm of ``F.scaled_dot_product_attention``. Dropout
(``cfg.dropout``, 0.1 in the published configurations) draws from the
generator the caller or the training step passes, and is replayed in
recompute (``ernie3_xl`` has both).

``attention_mask`` [B, T] follows Paddle's semantics: 1 = attend, 0 =
padding, and padded keys get no weight. The JAX package departs from
them (``paddle_tpu/models/ernie.py:138-141``): it hands the additive
mask ``(1 - m) * -1e9`` to a function that reads a boolean keep-mask
(``paddle_tpu/nn/functional.py:606-607``), so its kept keys drop out and
its padded keys stay. The port does not copy that fault
(``tests/test_torch_ernie.py`` pins the difference; ROADMAP Queue C).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.device import dtype_of, make_generator, resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.norm import LayerNorm
from paddle_tpu_torch.nn.scan import run_blocks

__all__ = ["ErnieConfig", "ErnieBlock", "ErnieModel", "ErnieForPretraining"]


@dataclass(frozen=True)
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 4
    dropout: float = 0.1
    dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    init_std: float = 0.02

    @classmethod
    def base(cls) -> "ErnieConfig":
        return cls()

    @classmethod
    def large(cls) -> "ErnieConfig":
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096)

    @classmethod
    def ernie3_xl(cls) -> "ErnieConfig":
        """ERNIE-3.0-style scale-up (shared-backbone width)."""
        return cls(hidden_size=4096, num_layers=48, num_heads=64,
                   intermediate_size=16384, remat=True)

    @classmethod
    def tiny(cls, **kw) -> "ErnieConfig":
        base = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128, max_seq_len=64,
                    dropout=0.0, dtype="float32")
        base.update(kw)
        return cls(**base)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class ErnieBlock(nn.Module):
    """Post-LN encoder block (residual, then LayerNorm)."""

    def __init__(self, cfg: ErnieConfig, *, device, dtype, generator):
        super().__init__()
        E, I_ = cfg.hidden_size, cfg.intermediate_size
        std = cfg.init_std
        out_std = cfg.init_std / math.sqrt(2 * cfg.num_layers)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wqkv = Linear(E, 3 * E, std=std, **kw)
        self.wo = Linear(E, E, std=out_std, **kw)
        self.attn_ln = LayerNorm(E, device=device, dtype=dtype)
        self.fc1 = Linear(E, I_, std=std, **kw)
        self.fc2 = Linear(I_, E, std=out_std, **kw)
        self.ffn_ln = LayerNorm(E, device=device, dtype=dtype)
        self.drop = Dropout(cfg.dropout)
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.head_dim

    def forward(self, x, mask=None, *, training: bool = False,
                generator: torch.Generator | None = None):
        """``mask``: None, or a boolean keep-mask broadcastable to
        [B, H, T, T]."""
        B, T, E = x.shape
        qkv = self.wqkv(x).reshape(B, T, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        a = F.scaled_dot_product_attention(q, k, v, mask, causal=False)
        x = self.attn_ln(x + self.drop(self.wo(a.reshape(B, T, E)),
                                       training, generator))
        h = self.fc2(F.gelu(self.fc1(x), approximate=True))
        return self.ffn_ln(x + self.drop(h, training, generator))


class ErnieModel(nn.Module):
    """Backbone: embeddings → encoder stack → ``(sequence_output,
    pooled)``."""

    def __init__(self, cfg: ErnieConfig, *, device, dtype, generator):
        super().__init__()
        E = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.word_emb = Embedding(cfg.vocab_size, E, std=cfg.init_std,
                                  generator=generator, **kw)
        self.pos_emb = Embedding(cfg.max_seq_len, E, std=cfg.init_std,
                                 generator=generator, **kw)
        self.type_emb = Embedding(cfg.type_vocab_size, E, std=cfg.init_std,
                                  generator=generator, **kw)
        self.emb_ln = LayerNorm(E, **kw)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(
            ErnieBlock(cfg, generator=generator, **kw)
            for _ in range(cfg.num_layers))
        self.pooler = Linear(E, E, std=cfg.init_std, generator=generator,
                             **kw)
        self.config = cfg

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                *, training: bool = False,
                generator: torch.Generator | None = None):
        """``attention_mask`` [B, T]: 1 = attend, 0 = padding (Paddle's
        semantics; see the module docstring)."""
        cfg = self.config
        T = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(T, device=input_ids.device)
        x = (self.word_emb(input_ids) + self.pos_emb(positions)
             + self.type_emb(token_type_ids))
        x = self.drop(self.emb_ln(x), training, generator)
        mask = None
        if attention_mask is not None:
            mask = (attention_mask != 0)[:, None, None, :]   # [B, 1, 1, T]
        x = run_blocks(self.blocks, x, mask, remat=cfg.remat,
                       policy=cfg.remat_policy, training=training,
                       generator=generator)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForPretraining(nn.Module):
    """MLM + sentence-order heads (the ERNIE pretraining objectives). The
    MLM decoder is tied to the word embedding.

    ``device=None`` builds on the current CUDA device and raises without
    one; pass ``device="cpu"`` for the host. ``dtype=None`` takes
    ``cfg.dtype``. Weights are drawn from ``generator`` (else a generator
    on ``device`` seeded with 0)."""

    def __init__(self, cfg: ErnieConfig, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype_of(dtype or cfg.dtype)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        E = cfg.hidden_size
        self.ernie = ErnieModel(cfg, **kw)
        self.mlm_transform = Linear(E, E, std=cfg.init_std, **kw)
        self.mlm_ln = LayerNorm(E, device=device, dtype=dtype)
        self.sop_head = Linear(E, 2, std=cfg.init_std, **kw)
        self.config = cfg

    @property
    def device(self) -> torch.device:
        return self.ernie.word_emb.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                *, training: bool = False,
                generator: torch.Generator | None = None):
        """``(mlm_logits [B, T, V], sop_logits [B, 2])``."""
        seq, pooled = self.ernie(input_ids, token_type_ids, attention_mask,
                                 training=training, generator=generator)
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq), approximate=True))
        mlm_logits = h @ self.ernie.word_emb.weight.T
        return mlm_logits, self.sop_head(pooled)

    def loss(self, input_ids, labels, token_type_ids=None,
             attention_mask=None, sop_labels=None, ignore_index: int = -100,
             training: bool = True,
             generator: torch.Generator | None = None):
        """MLM cross entropy over the positions whose label is not
        ``ignore_index``, plus the sentence-order loss when ``sop_labels``
        are given."""
        mlm_logits, sop_logits = self(input_ids, token_type_ids,
                                      attention_mask, training=training,
                                      generator=generator)
        loss = F.cross_entropy(mlm_logits.float(), labels,
                               ignore_index=ignore_index)
        if sop_labels is not None:
            loss = loss + F.cross_entropy(sop_logits.float(), sop_labels)
        return loss
