"""Host-side runtime pieces of the port — its own copies, cut to what the
serving engine reads, of ``paddle_tpu/core/{flags,monitor,trace,fault}.py``:
the flag registry with the ``gen_*`` flags, the stat and histogram
registry, the flag-gated span tracer and the fault-injection hooks."""

from paddle_tpu_torch.core import fault, flags, monitor, trace

__all__ = ["fault", "flags", "monitor", "trace"]
