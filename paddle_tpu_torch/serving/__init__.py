"""Serving — the port of ``paddle_tpu/serving``: so far the
continuous-batching ``GenerationEngine`` (contiguous and paged modes) and
its exceptions. The wire, router, batcher, scheduler and control plane
are ROADMAP A2d."""

from paddle_tpu_torch.serving.engine import (EXPIRED_MARKER,
                                             EngineOverloaded, Generation,
                                             GenerationEngine,
                                             GenerationExpired,
                                             RequestQuarantined)

__all__ = ["GenerationEngine", "Generation", "EngineOverloaded",
           "RequestQuarantined", "GenerationExpired", "EXPIRED_MARKER"]
