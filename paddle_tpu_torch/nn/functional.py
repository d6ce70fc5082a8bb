"""Functional ops — the subset of ``paddle_tpu/nn/functional.py`` that the
Llama serving path needs. Hot ops go through the port's kernels
(``paddle_tpu_torch.kernels``), which launch on CUDA tensors and run
their plain versions on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch import kernels

__all__ = ["silu", "swiglu", "linear", "embedding", "rms_norm",
           "rotary_embedding", "apply_rotary",
           "scaled_dot_product_attention"]


def silu(x):
    return torch.nn.functional.silu(x)


def swiglu(x, gate):
    """SwiGLU combine used by Llama-style MLPs: silu(gate) * x."""
    return silu(gate) * x


def linear(x, weight, bias=None):
    """y = x @ W (+ b) with the JAX package's weight layout [in, out]."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(ids, weight):
    """Row gather from the [V, E] table."""
    return weight[ids]


def rms_norm(x, weight, epsilon: float = 1e-6):
    """RMSNorm over the last axis (fp32 statistics) — the rms_norm
    kernel."""
    return kernels.norm.rms_norm(x, weight, epsilon)


def rotary_embedding(positions, dim: int, base: float = 10000.0):
    """RoPE tables for integer positions: (cos, sin), each
    [..., dim/2] fp32."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """Rotate [B, T, H, D] split halves by [T, D/2] tables — the rope
    kernel."""
    return kernels.rope.apply_rotary(x, cos, sin)


def scaled_dot_product_attention(q, k, v, *, causal: bool = False,
                                 scale: float | None = None):
    """Attention core over [B, T, H, D], grouped-query heads allowed
    (Hq % Hkv == 0) — the flash kernel on CUDA, its plain einsum version
    on the CPU. Never torch's own fused attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return kernels.flash_attention.flash_attention(q, k, v, causal=causal,
                                                   scale=scale)
