"""Learning-rate schedules — the port of the schedules of
``paddle_tpu/optimizer/lr.py`` that the training step uses
(``LRScheduler`` :22-37, ``CosineAnnealingDecay`` :112-119,
``LinearWarmup`` :122-144, ``warmup_cosine`` :178-184).

A schedule is a callable ``step -> lr`` of the optimizer's step counter
(0 at the first update). The JAX package evaluates it on the device in
fp32 inside the jitted step; the port's optimizer runs on the host
between launches, so here it is plain Python arithmetic on floats.
"""

from __future__ import annotations

import math

__all__ = ["LRScheduler", "CosineAnnealingDecay", "LinearWarmup",
           "warmup_cosine"]


class LRScheduler:
    """Base: a callable step -> lr. Subclasses implement ``get_lr``."""

    def __init__(self, learning_rate: float = 0.1):
        self.base_lr = float(learning_rate)

    def __call__(self, step) -> float:
        return float(self.get_lr(float(step)))

    def get_lr(self, step: float) -> float:  # pragma: no cover - abstract
        raise NotImplementedError


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, t_max: int,
                 eta_min: float = 0.0):
        super().__init__(learning_rate)
        self.t_max, self.eta_min = t_max, eta_min

    def get_lr(self, step):
        cos = math.cos(math.pi * min(step, self.t_max) / self.t_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class LinearWarmup(LRScheduler):
    """Wrap another schedule (or a constant) with a linear warmup from
    ``start_lr`` to ``end_lr`` (default: the wrapped schedule's first
    value) over ``warmup_steps``."""

    def __init__(self, learning_rate, warmup_steps: int,
                 start_lr: float = 0.0, end_lr: float | None = None):
        base = (learning_rate if isinstance(learning_rate, (int, float))
                else 0.0)
        super().__init__(base)
        self.inner = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr

    def get_lr(self, step):
        if callable(self.inner):
            after = self.inner(max(step - self.warmup_steps, 0.0))
            end = self.end_lr if self.end_lr is not None else self.inner(0.0)
        else:
            after = float(self.inner)
            end = self.end_lr if self.end_lr is not None else self.inner
        frac = min(step / max(self.warmup_steps, 1), 1.0)
        warm = self.start_lr + (end - self.start_lr) * frac
        return warm if step < self.warmup_steps else after


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> LinearWarmup:
    """The standard LLM pretraining schedule: linear warmup to
    ``peak_lr``, then cosine decay to ``end_lr`` at ``total_steps``."""
    return LinearWarmup(
        CosineAnnealingDecay(peak_lr, max(total_steps - warmup_steps, 1),
                             end_lr),
        warmup_steps, start_lr=0.0, end_lr=peak_lr)
