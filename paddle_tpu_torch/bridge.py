"""Weight bridge between the JAX package's flat state dict and the port's.

``paddle_tpu.io.checkpoint.state_dict(model)`` gives ``{dotted name:
numpy array}``. Its Llama layers are ONE scanned block whose leaves carry
a leading layer axis (``blocks.block.attn.wq.weight`` of shape
``[L, in, out]``); the port has an ``nn.ModuleList``
(``blocks.<i>.attn.wq.weight`` of shape ``[in, out]``). ``Linear``
weights keep the ``[in, out]`` layout on both sides, so arrays cross
unchanged apart from the unstacking. ``embed.weight``, ``norm.weight``
and ``lm_head.weight`` map by name.

Takes and returns numpy arrays: no JAX here.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.optimizer.optimizers import AdamWState

__all__ = ["from_jax_state_dict", "to_jax_state_dict", "load_jax_state_dict",
           "grads_state_dict", "adamw_state_from_jax", "adamw_state_to_jax"]

_STACKED = "blocks.block."


def from_jax_state_dict(state: dict, num_layers: int) -> dict:
    """JAX names/arrays → the port's names/arrays (numpy)."""
    out = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        if name.startswith(_STACKED):
            rest = name[len(_STACKED):]
            if arr.shape[0] != num_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} is "
                                 f"not the layer count {num_layers}")
            for i in range(num_layers):
                out[f"blocks.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    return out


def to_jax_state_dict(state: dict, num_layers: int) -> dict:
    """The port's names/arrays → JAX names/arrays (restacks the layers)."""
    out, per_layer = {}, {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        if name.startswith("blocks."):
            idx, rest = name[len("blocks."):].split(".", 1)
            per_layer.setdefault(rest, {})[int(idx)] = arr
        else:
            out[name] = arr
    for rest, layers in per_layer.items():
        if sorted(layers) != list(range(num_layers)):
            raise ValueError(f"{rest}: layers {sorted(layers)} are not "
                             f"0..{num_layers - 1}")
        out[_STACKED + rest] = np.stack([layers[i]
                                         for i in range(num_layers)])
    return out


def load_jax_state_dict(model: torch.nn.Module, state: dict) -> None:
    """Copy a JAX state dict into ``model`` in place, on the model's
    device and in each parameter's dtype. Every name must match both
    ways."""
    mapped = from_jax_state_dict(state, model.config.num_layers)
    own = model.state_dict()
    missing = sorted(set(own) - set(mapped))
    extra = sorted(set(mapped) - set(own))
    if missing or extra:
        raise KeyError(f"bridge: missing {missing}, unexpected {extra}")
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
    for tree in (mu, nu):
        mapped = from_jax_state_dict(tree, L)
        if set(mapped) != set(own):
            raise KeyError(f"bridge: moments for "
                           f"{sorted(set(mapped) ^ set(own))} do not match "
                           "the model's parameters")
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
