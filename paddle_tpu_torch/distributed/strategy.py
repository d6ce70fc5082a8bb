"""``DistributedStrategy`` — the port of ``paddle_tpu/core/strategy.py``
as far as one device goes.

Every section of the JAX package's strategy is here under its name, so
that a strategy written for the JAX package reads the same, and each is
an on/off switch that the port's training step does not run yet: turning
one on asks for parallelism, mixed precision with a loss scaler,
gradient merging (ROADMAP Queue A6) or a strategy-level recompute
override, and ``build_train_step`` raises. Per-block recompute is the
model's own ``LlamaConfig.remat`` / ``remat_policy``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["DistributedStrategy", "Section", "SECTIONS"]


@dataclass
class Section:
    """A strategy section the port does not run yet."""
    enable: bool = False


SECTIONS = ("recompute", "amp", "gradient_merge", "localsgd", "dgc",
            "fp16_allreduce", "sharding", "pipeline", "tensor_parallel",
            "sequence_parallel", "expert_parallel")


@dataclass
class DistributedStrategy:
    recompute: Section = field(default_factory=Section)
    amp: Section = field(default_factory=Section)
    gradient_merge: Section = field(default_factory=Section)
    localsgd: Section = field(default_factory=Section)
    dgc: Section = field(default_factory=Section)
    fp16_allreduce: Section = field(default_factory=Section)
    sharding: Section = field(default_factory=Section)
    pipeline: Section = field(default_factory=Section)
    tensor_parallel: Section = field(default_factory=Section)
    sequence_parallel: Section = field(default_factory=Section)
    expert_parallel: Section = field(default_factory=Section)

    def enabled_sections(self) -> list[str]:
        """The sections that are switched on."""
        return [name for name in SECTIONS if getattr(self, name).enable]
