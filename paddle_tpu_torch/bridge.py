"""Weight bridge between the JAX package's flat state dict and the port's.

``paddle_tpu.io.checkpoint.state_dict(model)`` gives ``{dotted name:
numpy array}``. A JAX model's layers are ONE scanned block whose leaves
carry a leading layer axis, under ``<prefix>blocks.block.`` (Llama and
GPT: ``blocks.block.attn.wq.weight`` of shape ``[L, in, out]``; ERNIE
nests it: ``ernie.blocks.block.wqkv.weight``); the port has an
``nn.ModuleList`` (``<prefix>blocks.<i>.<rest>`` of shape ``[in, out]``).
``Linear`` weights and biases keep their layout on both sides, so arrays
cross unchanged apart from the unstacking. Every other name maps as it
is.

Takes and returns numpy arrays: no JAX here.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from paddle_tpu_torch.optimizer.optimizers import AdamWState

__all__ = ["from_jax_state_dict", "to_jax_state_dict", "load_jax_state_dict",
           "grads_state_dict", "adamw_state_from_jax", "adamw_state_to_jax"]

_STACKED = re.compile(r"^((?:.*\.)?)blocks\.block\.(.+)$")
_LAYER = re.compile(r"^((?:.*\.)?)blocks\.(\d+)\.(.+)$")


def from_jax_state_dict(state: dict, num_layers: int) -> dict:
    """JAX names/arrays → the port's names/arrays (numpy): each
    ``<prefix>blocks.block.<rest>`` [L, ...] becomes ``<prefix>blocks.<i>.
    <rest>`` for i < L."""
    out = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        stacked = _STACKED.match(name)
        if stacked is None:
            out[name] = arr
            continue
        prefix, rest = stacked.groups()
        if arr.shape[0] != num_layers:
            raise ValueError(f"{name}: leading axis {arr.shape[0]} is not "
                             f"the layer count {num_layers}")
        for i in range(num_layers):
            out[f"{prefix}blocks.{i}.{rest}"] = arr[i]
    return out


def to_jax_state_dict(state: dict, num_layers: int) -> dict:
    """The port's names/arrays → JAX names/arrays: restacks each
    ``<prefix>blocks.<i>.<rest>`` into ``<prefix>blocks.block.<rest>``."""
    out, per_layer = {}, {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        layer = _LAYER.match(name)
        if layer is None:
            out[name] = arr
            continue
        prefix, idx, rest = layer.groups()
        per_layer.setdefault((prefix, rest), {})[int(idx)] = arr
    for (prefix, rest), layers in per_layer.items():
        if sorted(layers) != list(range(num_layers)):
            raise ValueError(f"{prefix}blocks.*.{rest}: layers "
                             f"{sorted(layers)} are not 0..{num_layers - 1}")
        out[f"{prefix}blocks.block.{rest}"] = np.stack(
            [layers[i] for i in range(num_layers)])
    return out


def _check_names(mapped: dict, own, what: str) -> None:
    """Raise ``KeyError`` unless ``mapped`` and ``own`` name the same
    tensors: nothing missing, nothing left over."""
    missing = sorted(set(own) - set(mapped))
    extra = sorted(set(mapped) - set(own))
    if missing or extra:
        raise KeyError(f"bridge: {what} missing {missing}, unexpected "
                       f"{extra}")


def load_jax_state_dict(model: torch.nn.Module, state: dict) -> None:
    """Copy a JAX state dict into ``model`` in place, on the model's
    device and in each parameter's dtype. Every name must match both
    ways."""
    mapped = from_jax_state_dict(state, model.config.num_layers)
    own = model.state_dict()
    _check_names(mapped, own, "weights")
    with torch.no_grad():
        for name, param in own.items():
            arr = mapped[name]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"bridge: {name} has shape {arr.shape}, "
                                 f"the port expects {tuple(param.shape)}")
            src = torch.from_numpy(np.ascontiguousarray(
                arr.astype(np.float32)))
            param.copy_(src.to(param.dtype))


def grads_state_dict(model: torch.nn.Module) -> dict:
    """The port's gradients as ``{parameter name: numpy array}`` (fp32),
    zeros where a parameter has none."""
    return {name: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().float().cpu().numpy()
            for name, p in model.named_parameters()}


def adamw_state_from_jax(count: int, mu: dict, nu: dict,
                         model: torch.nn.Module) -> AdamWState:
    """The JAX package's ``AdamState`` (its ``count`` and the flat JAX-named
    ``mu``/``nu``) as the port's ``AdamWState`` on the model's device, in
    fp32. Every name must match the model's parameters."""
    L = model.config.num_layers
    own = dict(model.named_parameters())
    moments = []
    for what, tree in (("mu", mu), ("nu", nu)):
        mapped = from_jax_state_dict(tree, L)
        _check_names(mapped, own, f"AdamW moments {what}")
        moments.append({
            name: torch.from_numpy(np.ascontiguousarray(
                mapped[name], dtype=np.float32)).to(own[name].device)
            for name in own})
    return AdamWState(int(count), *moments)


def adamw_state_to_jax(state: AdamWState, num_layers: int):
    """The port's ``AdamWState`` as ``(count, mu, nu)`` with flat JAX-named
    numpy moments (layers restacked)."""
    def flat(moments):
        return to_jax_state_dict({n: t.detach().cpu().numpy()
                                  for n, t in moments.items()}, num_layers)
    return state.count, flat(state.mu), flat(state.nu)
