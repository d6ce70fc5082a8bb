"""``RMSNorm`` — counterpart of ``paddle_tpu/nn/norm.py:49``."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["RMSNorm"]


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
