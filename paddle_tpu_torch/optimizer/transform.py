"""Gradient-norm pieces of ``paddle_tpu/optimizer/transform.py`` —
``global_norm`` (:274-277) and ``clip_by_global_norm`` (:280-290) — in
plain torch. They are reductions that the JAX package leaves to XLA, not
Pallas kernels.
"""

from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm_"]


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ over the tensors of Σ x²), in fp32, as a 0-d tensor on the
    tensors' device."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(tensors, max_norm: float) -> torch.Tensor:
    """Scale the tensors in place by ``min(1, max_norm / norm)`` (each in
    fp32, stored back in its own type); returns the norm before the
    clip."""
    tensors = list(tensors)
    norm = global_norm(tensors)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    with torch.no_grad():
        for t in tensors:
            t.copy_(t.float() * factor)
    return norm
