"""The port's ``nn`` subset: functional ops, ``Linear``, ``Embedding`` and
``RMSNorm``."""

from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.nn.common import Embedding, Linear
from paddle_tpu_torch.nn.norm import RMSNorm

__all__ = ["functional", "Embedding", "Linear", "RMSNorm"]
