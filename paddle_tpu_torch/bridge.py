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

__all__ = ["from_jax_state_dict", "to_jax_state_dict", "load_jax_state_dict"]

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
