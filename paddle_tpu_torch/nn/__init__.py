"""The port's ``nn`` subset: functional ops (the losses included),
``Linear``, ``Embedding``, ``Dropout``, ``RMSNorm``, ``LayerNorm`` and
per-block recompute (``scan``)."""

from paddle_tpu_torch.nn import functional, scan
from paddle_tpu_torch.nn.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.norm import LayerNorm, RMSNorm

__all__ = ["functional", "scan", "Dropout", "Embedding", "Linear",
           "LayerNorm", "RMSNorm"]
