"""Serving — the port of ``paddle_tpu/serving``: the continuous-batching
``GenerationEngine`` (contiguous and paged modes) and its exceptions, the
request ledger (``RequestLedger``, ``GoodputMeter``, ``TenantBook``) and
the subprocess replica (``python -m paddle_tpu_torch.serving.
replica_main``); the server and client are ``paddle_tpu_torch.io``. The
router, batcher, scheduler, KV store and control plane are ROADMAP
A2d."""

from paddle_tpu_torch.serving.engine import (EXPIRED_MARKER,
                                             QUARANTINE_MARKER,
                                             EngineOverloaded, Generation,
                                             GenerationEngine,
                                             GenerationExpired,
                                             RequestQuarantined)
from paddle_tpu_torch.serving.ledger import (GOODPUT_BUCKETS, PHASES,
                                             GoodputMeter, RequestLedger,
                                             TenantBook)

__all__ = ["GenerationEngine", "Generation", "EngineOverloaded",
           "RequestQuarantined", "GenerationExpired", "EXPIRED_MARKER",
           "QUARANTINE_MARKER", "RequestLedger", "GoodputMeter",
           "TenantBook", "PHASES", "GOODPUT_BUCKETS"]
