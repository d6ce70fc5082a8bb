"""``Linear`` and ``Embedding`` — counterparts of ``paddle_tpu/nn/common.py``.

Weight layout: ``Linear.weight`` is ``[in, out]``, the JAX package's
layout (``y = x @ W``), not torch's ``[out, in]``. The weight bridge then
copies arrays as they are, and ``torch.matmul`` takes either layout at
the same cost.

Parameters are made on ``device`` in ``dtype`` at construction, drawn
from the caller's ``torch.Generator``: a 7B model is never built in host
memory first.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["Linear", "Embedding", "normal_parameter"]


def normal_parameter(shape, std: float, *, device, dtype,
                     generator=None) -> nn.Parameter:
    """An ``nn.Parameter`` of ``shape`` drawn from N(0, std²) on
    ``device``."""
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """y = x @ W, weight [in, out]; no bias (the Llama family has none)."""

    def __init__(self, in_features: int, out_features: int, *,
                 std: float = 0.02, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.weight = normal_parameter((in_features, out_features), std,
                                       device=device, dtype=dtype,
                                       generator=generator)
        self.in_features = int(in_features)
        self.out_features = int(out_features)

    def forward(self, x):
        return F.linear(x, self.weight)


class Embedding(nn.Module):
    """Lookup table [V, E]."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 std: float = 0.02, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.weight = normal_parameter((num_embeddings, embedding_dim), std,
                                       device=device, dtype=dtype,
                                       generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)
