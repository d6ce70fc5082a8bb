"""Device resolution and seeding — the port's ``paddle_tpu.device`` and
``core/rng.py`` counterparts.

The port runs on the card: ``resolve_device(None)`` is the current CUDA
device, and raises when there is none. The host is used only when the
caller asks for it (``device="cpu"``, as the CPU tests do).

Randomness comes from an explicit ``torch.Generator`` seeded by the
caller (``make_generator``), never from the global torch RNG. The JAX
package draws from threefry keys and the port from Philox, so the two
give different numbers from one seed: parity tests make their inputs
with numpy and hand them to both.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "make_generator", "dtype_of"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; ``"cpu"``/``"cuda:1"``/a
    ``torch.device`` → that device. Raises ``RuntimeError`` when a CUDA
    device is wanted (explicitly or by default) and none is found."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found: the port runs on the GPU by "
                "default; pass device='cpu' to run the plain versions on "
                "the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    return dev


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def dtype_of(name) -> torch.dtype:
    """``"bfloat16"`` / ``torch.bfloat16`` → ``torch.bfloat16``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}") from None
