"""The single-device training step — the port of
``paddle_tpu/distributed/fleet/strategy_compiler.py`` (``TrainState``
:47-52, ``build_train_step`` :108, the step's metrics :445-449).

The JAX package composes the strategy into one jitted, sharded step. The
port runs eagerly on one device: the loss forward, ``backward()`` (the
kernels' ``autograd.Function``s, with per-block recompute when the model
asks for it), the gradient norm, and the optimizer's in-place update.
Strategies that ask for more than one plain device raise.

Dropout: the JAX step opens an RNG stream on the step's key
(``strategy_compiler.py:294``); the port's step hands the loss a
``torch.Generator`` on the model's device — the caller's, or one seeded
with the step count — so a run is the same on every replay.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from paddle_tpu_torch.device import make_generator
from paddle_tpu_torch.distributed.strategy import DistributedStrategy
from paddle_tpu_torch.optimizer.transform import global_norm

__all__ = ["TrainState", "TrainStep", "build_train_step"]


class TrainState(NamedTuple):
    model: Any
    opt_state: Any
    step: int


def _default_loss(model, batch, generator):
    """``model.loss(input_ids, labels, **the batch's other entries,
    generator=generator)`` — e.g. ERNIE's ``sop_labels``."""
    extra = {k: v for k, v in batch.items()
             if k not in ("input_ids", "labels")}
    return model.loss(batch["input_ids"], batch["labels"], **extra,
                      generator=generator)


class TrainStep:
    """``init_state(model)`` then ``state, metrics = step(state, batch)``;
    ``metrics`` holds the step's ``loss`` and the gradients' global
    ``grad_norm`` before clipping, as 0-d fp32 tensors on the device.
    ``step(state, batch, generator)`` draws the step's dropout masks from
    ``generator``; without one, from a generator on the model's device
    seeded with ``state.step``."""

    def __init__(self, optimizer, loss_fn):
        self.optimizer = optimizer
        self.loss_fn = loss_fn

    def init_state(self, model) -> TrainState:
        return TrainState(model, self.optimizer.init(model), 0)

    def __call__(self, state: TrainState, batch,
                 generator: torch.Generator | None = None):
        model = state.model
        params = dict(model.named_parameters())
        if generator is None:
            device = next(iter(params.values())).device
            generator = make_generator(state.step, device)
        for p in params.values():
            p.grad = None
        loss = self.loss_fn(model, batch, generator)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        grad_norm = global_norm(grads.values())
        model, opt_state = self.optimizer.apply_gradients(
            model, grads, state.opt_state)
        metrics = {"loss": loss.detach().float(), "grad_norm": grad_norm}
        return TrainState(model, opt_state, state.step + 1), metrics


def build_train_step(model, optimizer, loss_fn=None, *,
                     strategy: DistributedStrategy | None = None
                     ) -> TrainStep:
    """The training step of ``model`` under ``optimizer``.
    ``loss_fn(model, batch, generator) -> scalar`` defaults to
    ``model.loss(batch["input_ids"], batch["labels"], **the batch's other
    entries, generator=generator)``; per-block recompute is the model's
    own ``config.remat`` / ``remat_policy``. A ``strategy`` with any
    section switched on raises."""
    strategy = strategy or DistributedStrategy()
    asked = strategy.enabled_sections()
    if asked:
        raise NotImplementedError(
            f"strategy sections {asked} are not in the port yet: its "
            "training step runs on one device, without a loss scaler or "
            "gradient merging, and takes per-block recompute from the "
            "model's config (remat, remat_policy)")
    return TrainStep(optimizer, loss_fn or _default_loss)
