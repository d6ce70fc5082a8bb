"""``Linear``, ``Embedding`` and ``Dropout`` — counterparts of
``paddle_tpu/nn/common.py``.

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

__all__ = ["Linear", "Embedding", "Dropout", "normal_parameter"]


def normal_parameter(shape, std: float, *, device, dtype,
                     generator=None) -> nn.Parameter:
    """An ``nn.Parameter`` of ``shape`` drawn from N(0, std²) on
    ``device``."""
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """y = x @ W + b, weight [in, out], bias [out] starting at zeros
    (``paddle_tpu/nn/common.py:59-73``). ``bias=False`` (the Llama family
    and the LM heads) registers no bias, so the state dict has no such
    entry."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, std: float = 0.02, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.weight = normal_parameter((in_features, out_features), std,
                                       device=device, dtype=dtype,
                                       generator=generator)
        self.bias = (nn.Parameter(torch.zeros((out_features,),
                                              device=device, dtype=dtype))
                     if bias else None)
        self.in_features = int(in_features)
        self.out_features = int(out_features)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


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


class Dropout(nn.Module):
    """Inverted dropout with rate ``p``; the mask comes from the
    ``generator`` each call passes (``F.dropout``), and only when
    ``training``."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x, training: bool = False,
                generator: torch.Generator | None = None):
        return F.dropout(x, self.p, training=training, generator=generator)
