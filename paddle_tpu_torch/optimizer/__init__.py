"""paddle_tpu_torch.optimizer — ``AdamW``, the learning-rate schedules of
the training step and the global-norm gradient clip (the port of
``paddle_tpu/optimizer``)."""

from paddle_tpu_torch.optimizer import lr, transform
from paddle_tpu_torch.optimizer.optimizers import AdamW, AdamWState, Optimizer
from paddle_tpu_torch.optimizer.transform import (clip_by_global_norm_,
                                                  global_norm)

__all__ = ["lr", "transform", "AdamW", "AdamWState", "Optimizer",
           "ClipGradByGlobalNorm", "clip_by_global_norm_", "global_norm"]


class ClipGradByGlobalNorm:
    """Scale the gradients so that their global norm is at most
    ``clip_norm`` (``paddle_tpu/optimizer/__init__.py:21-26``)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        """Clip ``grads`` in place; returns their norm before the clip."""
        return clip_by_global_norm_(grads, self.clip_norm)
