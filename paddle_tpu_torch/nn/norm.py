"""``RMSNorm`` and ``LayerNorm`` — counterparts of
``paddle_tpu/nn/norm.py:49`` and ``:31-46``."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["RMSNorm", "LayerNorm"]


class RMSNorm(nn.Module):
    """Llama-family norm; the weight starts at ones."""

    def __init__(self, dim: int, *, epsilon: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.ones((dim,), device=device, dtype=dtype))
        self.epsilon = float(epsilon)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (the GPT and ERNIE norm); weight starts
    at ones and bias at zeros."""

    def __init__(self, dim: int, *, epsilon: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.ones((dim,), device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros((dim,), device=device, dtype=dtype))
        self.epsilon = float(epsilon)

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)
