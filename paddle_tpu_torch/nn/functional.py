"""Functional ops — the subset of ``paddle_tpu/nn/functional.py`` that the
Llama, GPT, ERNIE and Mamba serving and training paths need. Hot ops go
through the port's kernels (``paddle_tpu_torch.kernels``), which launch on
CUDA tensors and run their plain versions on CPU tensors; all of them are
differentiable. Randomness (``dropout``) comes from the caller's
``torch.Generator``, never from torch's global RNG.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import softmax_xent as SX

__all__ = ["silu", "swiglu", "gelu", "softplus", "linear", "embedding", "dropout",
           "rms_norm", "layer_norm", "rotary_embedding", "apply_rotary",
           "scaled_dot_product_attention", "softmax_with_cross_entropy",
           "cross_entropy", "check_head_mode", "linear_cross_entropy",
           "chunked_linear_cross_entropy", "next_token_linear_loss"]

HEAD_MODES = ("auto", "fused", "chunked", "dense")


def silu(x):
    return torch.nn.functional.silu(x)


def swiglu(x, gate):
    """SwiGLU combine used by Llama-style MLPs: silu(gate) * x."""
    return silu(gate) * x


def gelu(x, approximate: bool = False):
    """GELU; ``approximate`` takes the tanh form (``jax.nn.gelu``'s
    ``approximate=True``, which GPT and ERNIE use)."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")


def softplus(x, beta: float = 1.0, threshold: float = 20.0):
    """``log(1 + exp(beta·x)) / beta``, and ``x`` itself where ``beta·x >
    threshold`` (``paddle_tpu/nn/functional.py:110-112``)."""
    xb = x * beta
    return torch.where(xb > threshold, x,
                       torch.nn.functional.softplus(xb) / beta)


def linear(x, weight, bias=None):
    """y = x @ W (+ b) with the JAX package's weight layout [in, out]."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(ids, weight):
    """Row gather from the [V, E] table."""
    return weight[ids]


def dropout(x, p: float = 0.5, training: bool = True,
            generator: torch.Generator | None = None):
    """Inverted dropout (``paddle_tpu/nn/functional.py:284-298``): each
    element kept with probability ``1 - p`` and scaled by ``1 / (1 -
    p)``. The keep mask is drawn from ``generator`` (on ``x``'s device),
    which training requires: the port never draws from torch's global
    RNG. Identity when not ``training`` or ``p == 0``."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout(training=True) needs a torch.Generator: "
                         "pass generator= (the training step passes one, "
                         "seeded per step)")
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def rms_norm(x, weight, epsilon: float = 1e-6):
    """RMSNorm over the last axis (fp32 statistics) — the rms_norm
    kernel."""
    return kernels.norm.rms_norm(x, weight, epsilon)


def layer_norm(x, weight=None, bias=None, epsilon: float = 1e-5,
               axis=-1):
    """LayerNorm over ``axis`` (``paddle_tpu/nn/functional.py:149``).

    Over the last axis: the layer_norm kernel (fp32 statistics); a
    missing weight is ones and a missing bias zeros, as in the JAX
    package's Pallas path. Over any other axis or axes (an int or a
    tuple): the JAX package's plain arm (``:158-166``) in torch ops, the
    mean, variance and affine step in x's type."""
    if axis in (-1, x.ndim - 1):
        h = x.shape[-1]
        if weight is None:
            weight = torch.ones(h, dtype=x.dtype, device=x.device)
        if bias is None:
            bias = torch.zeros(h, dtype=weight.dtype, device=x.device)
        return kernels.norm.layer_norm(x, weight, bias, epsilon)
    dims = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def rotary_embedding(positions, dim: int, base: float = 10000.0,
                     dtype=torch.float32):
    """RoPE tables for integer positions: (cos, sin), each
    [..., dim/2], computed in fp32 and returned in ``dtype``."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x, cos, sin):
    """Rotate [B, T, H, D] split halves by [T, D/2] tables shared by the
    batch, or [B, T, D/2] tables of each row's own positions — the rope
    kernel."""
    return kernels.rope.apply_rotary(x, cos, sin)


PALLAS_MODES = ("auto", "always", "never")


def scaled_dot_product_attention(q, k, v, mask=None, *,
                                 causal: bool = False,
                                 scale: float | None = None,
                                 dropout_p: float = 0.0,
                                 training: bool = False,
                                 use_pallas="auto",
                                 generator: torch.Generator | None = None):
    """Attention core over [B, T, H, D], grouped-query heads allowed
    (Hq % Hkv == 0). Never torch's own fused attention.

    Without ``mask`` and dropout, and unless ``use_pallas`` is ``"never"``
    (or False): the flash kernel on CUDA, its plain einsum version on the
    CPU — where the JAX package dispatches its Pallas kernel
    (``paddle_tpu/nn/functional.py:573-587``). ``"auto"`` and
    ``"always"`` (or True) both take the kernel: it takes every shape the
    port serves, and raises on one it does not.

    Otherwise the JAX package's einsum arm (``:589-611``) in torch ops:
    scores in the input type, the causal and ``mask`` positions (mask
    broadcastable to [B, H, Tq, Tk]; True or non-zero = attend, as
    ``jnp.where(mask, ...)`` reads it) set to the type's lowest value,
    softmax in fp32, probabilities cast back before the product; with
    ``dropout_p > 0`` and ``training`` the probabilities are dropped out
    (``dropout``, drawn from ``generator``). That arm is plain XLA in the
    JAX package, not a Pallas kernel, so it is no kernel fallback here; it
    runs on CUDA tensors as on CPU tensors."""
    if use_pallas in (True, False):
        use_pallas = "auto" if use_pallas else "never"
    if use_pallas not in PALLAS_MODES:
        raise ValueError(f"use_pallas {use_pallas!r}: one of "
                         f"{PALLAS_MODES} or a bool")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if mask is None and dropout_p == 0.0 and use_pallas != "never":
        return kernels.flash_attention.flash_attention(q, k, v,
                                                       causal=causal,
                                                       scale=scale)
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lowest = torch.finfo(logits.dtype).min
    Tq, Tk = q.shape[1], k.shape[1]
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(
            Tk - Tq)
        logits = logits.masked_fill(~keep, lowest)
    if mask is not None:
        keep = mask if mask.dtype == torch.bool else mask != 0
        logits = logits.masked_fill(~keep, lowest)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True, generator=generator)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# Losses (``paddle_tpu/nn/functional.py:326-495``)
# ---------------------------------------------------------------------------

def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100, axis: int = -1):
    """Per-position softmax cross entropy (``paddle_tpu/nn/functional.py
    :326-370``).

    Int labels over the last axis with ``V % 256 == 0``, ``V <= 2048``
    and fp32 or bf16 logits take the softmax cross-entropy kernels (B14
    forward, B15 backward; their plain versions on CPU tensors) under the
    JAX package's gate: the rows are padded to the kernel's row block with
    ``ignore_index`` labels, positions at ``ignore_index`` get 0, and the
    loss comes back in the logits' type (``:339-363``). Otherwise
    ``log_softmax``: ``-sum(label · logp)`` with ``soft_label``, else the
    label's negative log-probability, 0 where the label is
    ``ignore_index``."""
    if (not soft_label and axis in (-1, logits.ndim - 1)
            and not label.is_floating_point()):
        v = logits.shape[-1]
        if (v % SX.BLOCK_V == 0 and v <= SX.DISPATCH_MAX_V
                and logits.dtype in (torch.float32, torch.bfloat16)):
            flat, lab = logits.reshape(-1, v), label.reshape(-1)
            n = flat.shape[0]
            pad = SX.row_pad(n)
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad, v)])
                lab = torch.cat([lab, lab.new_full((pad,), ignore_index)])
            if SX.supported(flat, lab):
                valid = lab != ignore_index
                loss = SX.softmax_cross_entropy(
                    flat, torch.where(valid, lab, 0))
                loss = torch.where(valid, loss, 0.0).to(logits.dtype)
                return loss[:n].reshape(label.shape)
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        return -(label * logp).sum(dim=axis)
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


def cross_entropy(logits, label, soft_label: bool = False,
                  ignore_index: int = -100, reduction: str = "mean",
                  weight=None, axis: int = -1):
    """Cross entropy (``paddle_tpu/nn/functional.py:373-400``). Int
    labels: ``"mean"`` averages over the positions whose label is not
    ``ignore_index``; a per-class ``weight`` [V] scales each position by
    its label's weight (0 at ``ignore_index``) and ``"mean"`` divides by
    the weights' sum. Soft labels: ``"mean"`` is the plain mean; with
    ``weight`` the weights fold into the inner sum,
    ``-sum_c label_c·w_c·logp_c``, and ``"mean"`` divides by the total
    effective weight ``sum label·w``."""
    if weight is not None and soft_label:
        logp = torch.log_softmax(logits, dim=axis)
        loss = -(label * weight * logp).sum(dim=axis)
        if reduction == "mean":
            wsum = (label * weight).sum(dim=axis)
            return loss.sum() / wsum.sum().clamp_min(1e-12)
        return loss.sum() if reduction == "sum" else loss
    loss = softmax_with_cross_entropy(logits, label, soft_label,
                                      ignore_index, axis)
    if soft_label:
        if reduction == "mean":
            return loss.mean()
        return loss.sum() if reduction == "sum" else loss
    valid = label != ignore_index
    if weight is not None:
        w = torch.where(valid, weight[torch.where(valid, label, 0).long()],
                        0.0)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp_min(1e-12)
    return _reduce_valid(loss, valid, reduction)


def check_head_mode(mode: str) -> None:
    """Raise unless ``mode`` is one of ``HEAD_MODES``."""
    if mode not in HEAD_MODES:
        raise ValueError(f"linear_cross_entropy: unknown mode {mode!r} "
                         f"(expected one of {HEAD_MODES})")


def _chunk_merge(m, l, s, hidden, w_c, off, lab):
    """One vocab chunk's fp32 logits folded into the running (max, sum,
    label logit)."""
    return kernels.linear_xent.online_merge(
        m, l, s, hidden.float() @ w_c.float(), off, lab[:, None])


def chunked_linear_cross_entropy(hidden, weight, labels,
                                 block_v: int = 4096):
    """Per-row ``lse − label logit`` of ``hidden`` [N, E] @ ``weight``
    [E, V] over vocab chunks of ``block_v`` (the last one ragged) with a
    running max and sum, each chunk under ``torch.utils.checkpoint`` so
    that backward recomputes its logits instead of keeping them — the port
    of ``paddle_tpu/ops/pallas/linear_xent.py:343-384``, plain PyTorch as
    the JAX package's is plain XLA. Out-of-range labels select nothing."""
    n, v = hidden.shape[0], weight.shape[1]
    lab = labels.long()
    m = torch.full((n,), -1e30, device=hidden.device)
    l = torch.zeros((n,), device=hidden.device)
    s = torch.zeros((n,), device=hidden.device)
    for off in range(0, v, min(block_v, v)):
        m, l, s = checkpoint(_chunk_merge, m, l, s, hidden,
                             weight[:, off:off + block_v], off, lab,
                             use_reentrant=False)
    return m + torch.log(l) - s


def linear_cross_entropy(hidden, weight, label, ignore_index: int = -100,
                         reduction: str = "mean", mode: str = "auto"):
    """LM-head projection fused with softmax cross entropy
    (``paddle_tpu/nn/functional.py:406-478``): ``hidden`` [..., E] @
    ``weight`` [E, V] against int ``label`` [...], positions at
    ``ignore_index`` masked out. ``mode``:

    - ``"fused"``: ``kernels.linear_xent.fused_linear_cross_entropy``, the
      [N, V] logits never stored: the vocab-tiled kernels on CUDA tensors
      (bfloat16; other types raise, no quiet fallback), their plain
      versions on CPU tensors;
    - ``"chunked"``: ``chunked_linear_cross_entropy``, plain PyTorch;
    - ``"dense"``: the whole logits, rounded to the input type by the
      product and then taken to fp32, and ``cross_entropy``;
    - ``"auto"``: fused on CUDA tensors, dense on CPU tensors (the JAX
      package: fused on the TPU, dense off it).
    """
    check_head_mode(mode)
    e = hidden.shape[-1]
    flat = hidden.reshape(-1, e)
    lab = label.reshape(-1)
    if mode == "auto":
        mode = "fused" if flat.device.type == "cuda" else "dense"
    if mode == "fused":
        loss = kernels.linear_xent.fused_linear_cross_entropy(flat, weight,
                                                              lab)
    elif mode == "chunked":
        loss = chunked_linear_cross_entropy(flat, weight, lab)
    else:
        loss = softmax_with_cross_entropy((flat @ weight).float(), lab,
                                          ignore_index=ignore_index)
    valid = lab != ignore_index
    loss = _reduce_valid(torch.where(valid, loss, 0.0), valid, reduction)
    return loss.reshape(label.shape) if reduction == "none" else loss


def next_token_linear_loss(hidden, weight, labels, ignore_index: int = -100,
                           mode: str = "auto"):
    """Causal-LM head loss over ``hidden`` [B, T, E] with same-position
    ``labels`` [B, T]: the labels shift left one step and the last
    position is ignored, so all B·T rows go through the head."""
    check_head_mode(mode)
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                        ignore_index)], 1)
    return linear_cross_entropy(hidden, weight, shifted,
                                ignore_index=ignore_index, mode=mode)
