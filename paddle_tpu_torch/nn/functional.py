"""Functional ops — the subset of ``paddle_tpu/nn/functional.py`` that the
Llama serving and training paths need. Hot ops go through the port's
kernels (``paddle_tpu_torch.kernels``), which launch on CUDA tensors and
run their plain versions on CPU tensors; all of them are differentiable.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch import kernels

__all__ = ["silu", "swiglu", "linear", "embedding", "rms_norm",
           "rotary_embedding", "apply_rotary",
           "scaled_dot_product_attention", "softmax_with_cross_entropy",
           "cross_entropy", "check_head_mode", "linear_cross_entropy",
           "next_token_linear_loss"]

HEAD_MODES = ("auto", "fused", "chunked", "dense")


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


# ---------------------------------------------------------------------------
# Losses (``paddle_tpu/nn/functional.py:326-495``)
# ---------------------------------------------------------------------------

def softmax_with_cross_entropy(logits, label, ignore_index: int = -100,
                               axis: int = -1):
    """Per-position softmax cross entropy against int labels, 0 where the
    label is ``ignore_index``. Plain torch: at Llama's vocabulary the JAX
    package takes the same ``log_softmax`` + gather path (its Pallas
    kernel dispatches only for V <= 2048)."""
    logp = torch.log_softmax(logits, dim=axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    nll = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    return torch.where(valid, nll, torch.zeros_like(nll))


def _reduce_valid(loss, valid, reduction: str):
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction {reduction!r}: one of 'mean', 'sum', "
                     "'none'")


def cross_entropy(logits, label, ignore_index: int = -100,
                  reduction: str = "mean", axis: int = -1):
    """Cross entropy with int labels; ``"mean"`` averages over the
    positions whose label is not ``ignore_index``."""
    loss = softmax_with_cross_entropy(logits, label, ignore_index, axis)
    return _reduce_valid(loss, label != ignore_index, reduction)


def check_head_mode(mode: str) -> None:
    """Raise unless ``mode`` is a head mode that the port runs."""
    if mode not in HEAD_MODES:
        raise ValueError(f"linear_cross_entropy: unknown mode {mode!r} "
                         f"(expected one of {HEAD_MODES})")
    if mode != "dense":
        raise NotImplementedError(
            f"linear_cross_entropy mode {mode!r}: the fused and chunked "
            "vocab-tiled heads (kernels B11-B15) come with the fused-head "
            "slice of the port; only 'dense' runs so far")


def linear_cross_entropy(hidden, weight, label, ignore_index: int = -100,
                         reduction: str = "mean", mode: str = "dense"):
    """LM-head projection + cross entropy: ``hidden`` [..., E] @ ``weight``
    [E, V] in fp32, int ``label`` [...]. Only the dense mode (the whole
    [..., V] logits) is ported."""
    check_head_mode(mode)
    e = hidden.shape[-1]
    lab = label.reshape(-1)
    logits = (hidden.reshape(-1, e) @ weight).float()
    loss = softmax_with_cross_entropy(logits, lab, ignore_index)
    loss = _reduce_valid(loss, lab != ignore_index, reduction)
    return loss.reshape(label.shape) if reduction == "none" else loss


def next_token_linear_loss(hidden, weight, labels, ignore_index: int = -100,
                           mode: str = "dense"):
    """Causal-LM head loss over ``hidden`` [B, T, E] with same-position
    ``labels`` [B, T]: the labels shift left one step and the last
    position is ignored."""
    check_head_mode(mode)
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                        ignore_index)], 1)
    return linear_cross_entropy(hidden, weight, shifted,
                                ignore_index=ignore_index, mode=mode)
