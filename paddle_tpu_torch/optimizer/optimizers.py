"""The optimizer base and ``AdamW`` — the port of
``paddle_tpu/optimizer/optimizers.py:36-100`` and ``:119-143``.

Usage follows the JAX package's functional form:

    opt = AdamW(warmup_cosine(3e-4, 100, 10000),
                grad_clip=ClipGradByGlobalNorm(1.0))
    state = opt.init(model)
    model, state = opt.apply_gradients(model, grads, state)

with one difference: the parameters are updated IN PLACE (the JAX package
returns a new model), and ``grads`` is ``{parameter name: gradient}``
over ``model.named_parameters()``. The update keeps the JAX chain's order
— clip, Adam moments, decoupled weight decay, learning rate — and runs
each parameter tensor through one pass of the AdamW kernel
(``kernels/adamw.py``; its plain version on CPU tensors). Moments are
fp32 whatever the parameter's type. The kernel computes the whole update
in fp32 and rounds the parameter once, as the Pallas kernel does; the
JAX chain rounds the Adam step to the gradient's type first, so with
bf16 parameters the two differ by rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from paddle_tpu_torch.kernels.adamw import adamw_update

__all__ = ["Optimizer", "AdamW", "AdamWState"]


class AdamWState(NamedTuple):
    """``count`` updates applied so far (the schedule's step, and the
    1-based bias-correction step less one); fp32 moments by name."""
    count: int
    mu: dict
    nu: dict


def _as_schedule(lr) -> Callable:
    if callable(lr):
        return lr
    return lambda step: float(lr)


class Optimizer:
    """A learning rate (a float or a schedule of the step count), an
    optional gradient clip applied first, and a weight decay; subclasses
    define ``init`` and ``_update``."""

    def __init__(self, learning_rate=0.001, *, grad_clip=None,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.schedule = _as_schedule(learning_rate)
        self.grad_clip = grad_clip
        self.weight_decay = float(weight_decay)

    def init(self, model):  # pragma: no cover - abstract
        raise NotImplementedError

    def _update(self, params: dict, grads: dict, state, lr: float):
        raise NotImplementedError  # pragma: no cover - abstract

    def apply_gradients(self, model, grads: dict, state):
        """Clip ``grads`` (in place), then update the model's parameters
        in place; returns ``(model, new_state)``."""
        params = dict(model.named_parameters())
        if set(grads) != set(params):
            raise KeyError(f"gradients for {sorted(set(grads) ^ set(params))}"
                           " do not match the model's parameters")
        if self.grad_clip is not None:
            self.grad_clip(grads.values())
        lr = self.schedule(state.count)
        with torch.no_grad():
            return model, self._update(params, grads, state, lr)


class AdamW(Optimizer):
    """Adam with decoupled weight decay. ``decay_mask(name) -> bool``
    selects the decayed parameters (all by default), as the JAX package's
    mask pytree does."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01, decay_mask=None, **kwargs):
        super().__init__(learning_rate, weight_decay=weight_decay, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.decay_mask = decay_mask

    def init(self, model) -> AdamWState:
        named = list(model.named_parameters())
        return AdamWState(
            0, {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in named},
            {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named})

    def _update(self, params, grads, state, lr):
        step = state.count + 1
        for name, p in params.items():
            decays = self.decay_mask is None or self.decay_mask(name)
            adamw_update(p, state.mu[name], state.nu[name], grads[name],
                         lr=lr, beta1=self.beta1, beta2=self.beta2,
                         eps=self.epsilon,
                         weight_decay=self.weight_decay if decays else 0.0,
                         step=step)
        return AdamWState(step, state.mu, state.nu)
