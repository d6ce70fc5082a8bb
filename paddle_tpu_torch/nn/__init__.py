"""The port's ``nn`` subset: functional ops (the losses included),
``Linear``, ``Embedding``, ``RMSNorm`` and per-block recompute
(``scan``)."""

from paddle_tpu_torch.nn import functional, scan
from paddle_tpu_torch.nn.common import Embedding, Linear
from paddle_tpu_torch.nn.norm import RMSNorm

__all__ = ["functional", "scan", "Embedding", "Linear", "RMSNorm"]
