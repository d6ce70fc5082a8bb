"""Fused LM head ⊗ cross-entropy: CUDA kernels (``csrc/linear_xent.cu``),
their plain PyTorch versions, and the autograd wiring.

Replaces ``paddle_tpu/ops/pallas/linear_xent.py:187 _fwd_call`` (B11:
per-row ``lse`` and label logit ``sel`` of ``h @ W``), ``:221 _dh_call``
(B12: dH) and ``:247 _dw_call`` (B13: dW), and their custom VJP
(``:289-318``). The [N, V] logits never exist in device memory: the
kernels walk the vocabulary in tiles and keep fp32 row statistics.

Numerics follow the Pallas kernels: logits in fp32 from the input type;
``dlogits = (softmax − onehot)·g`` rounded to the input type before the
dH and dW products; both products accumulated in fp32, dH written in the
hidden's type and dW in the weight's. A label outside ``[0, V)`` (an
``ignore_index`` of -100) selects nothing: its row loss is the bare lse
and it adds no one-hot term to either gradient. The plain versions are
vocab-tiled fp32 PyTorch with a running max and lse, the same algorithm.

The backward kernels share one walk over the vocabulary: each chunk's
dlogits are computed once for both products (``_bwd_kernel``), and
``linear_xent_dh``/``linear_xent_dw`` run it for one gradient alone.

The kernels take bfloat16 (the training path's type); on a CUDA tensor of
another type the wrappers and ``fused_linear_cross_entropy`` raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["fused_linear_cross_entropy", "online_merge", "mismatch",
           "linear_xent_fwd", "linear_xent_fwd_reference",
           "linear_xent_dh", "linear_xent_dh_reference",
           "linear_xent_dw", "linear_xent_dw_reference"]

_FWD_NAME = "linear_xent_fwd"
_DH_NAME = "linear_xent_dh"
_DW_NAME = "linear_xent_dw"
VOCAB_CHUNK = 4096   # columns per backward chunk (kernels) and plain tile


def _tile_logits(hidden, w_tile, ct):
    """One vocab tile's logits in the compute type ``ct`` (fp32 for bf16
    and fp32 inputs, as the kernels' accumulators)."""
    return hidden.to(ct) @ w_tile.to(ct)


def online_merge(m, l, s, logits, off: int, lab):
    """Fold one vocab tile's ``logits`` [N, bv] (columns from ``off``)
    into the running row max ``m``, sum ``l`` of exp(logit − m) and label
    logit ``s``; ``lab`` is [N, 1]. A label outside the tile adds
    nothing."""
    col = off + torch.arange(logits.shape[1], device=logits.device)
    s = s + torch.where(col == lab, logits, 0.0).sum(dim=1)
    m_new = torch.maximum(m, logits.amax(dim=1))
    l = l * torch.exp(m - m_new) + torch.exp(
        logits - m_new[:, None]).sum(dim=1)
    return m_new, l, s


def linear_xent_fwd_reference(hidden, weight, labels, *,
                              block_v: int = VOCAB_CHUNK):
    """Plain forward: ``(lse [N], sel [N])`` in the compute type, over vocab
    tiles with a running max and sum (``linear_xent.py:103-130``)."""
    ct = _support.compute_dtype(hidden)
    n, v = hidden.shape[0], weight.shape[1]
    lab = labels.long()[:, None]
    m = torch.full((n,), float("-inf"), dtype=ct, device=hidden.device)
    l = torch.zeros((n,), dtype=ct, device=hidden.device)
    s = torch.zeros((n,), dtype=ct, device=hidden.device)
    for off in range(0, v, block_v):
        logits = _tile_logits(hidden, weight[:, off:off + block_v], ct)
        m, l, s = online_merge(m, l, s, logits, off, lab)
    return m + torch.log(l), s


def _dlogits(hidden, w_tile, off, lab, lse, g, dtype, ct):
    """``(softmax − onehot)·g`` of one recomputed tile, rounded to
    ``dtype`` (the kernels' rounding before the products)."""
    logits = _tile_logits(hidden, w_tile, ct)
    col = off + torch.arange(logits.shape[1], device=hidden.device)
    p = torch.exp(logits - lse.to(ct)[:, None])
    onehot = (col == lab).to(ct)
    return ((p - onehot) * g.to(ct)[:, None]).to(dtype).to(ct)


def linear_xent_dh_reference(hidden, weight, labels, lse, g, *,
                             block_v: int = VOCAB_CHUNK):
    """Plain dH [N, E] in the hidden's type: per vocab tile, the tile's
    dlogits (in the weight's type) times its weights transposed, summed in
    the compute type (``linear_xent.py:133-154``)."""
    ct = _support.compute_dtype(hidden)
    lab = labels.long()[:, None]
    acc = torch.zeros(hidden.shape, dtype=ct, device=hidden.device)
    for off in range(0, weight.shape[1], block_v):
        w_tile = weight[:, off:off + block_v]
        dlog = _dlogits(hidden, w_tile, off, lab, lse, g, weight.dtype, ct)
        acc += dlog @ w_tile.to(ct).T
    return acc.to(hidden.dtype)


def linear_xent_dw_reference(hidden, weight, labels, lse, g, *,
                             block_v: int = VOCAB_CHUNK):
    """Plain dW [E, V] in the weight's type: per vocab tile, hᵀ times the
    tile's dlogits (in the hidden's type), summed over the rows in the
    compute type (``linear_xent.py:157-180``)."""
    ct = _support.compute_dtype(hidden)
    lab = labels.long()[:, None]
    dw = torch.empty(weight.shape, dtype=weight.dtype, device=weight.device)
    hf = hidden.to(ct)
    for off in range(0, weight.shape[1], block_v):
        w_tile = weight[:, off:off + block_v]
        dlog = _dlogits(hidden, w_tile, off, lab, lse, g, hidden.dtype, ct)
        dw[:, off:off + block_v] = (hf.T @ dlog).to(weight.dtype)
    return dw


def mismatch(got, want, atol: float, rtol: float, scaled: bool) -> float:
    """The largest ``|got − want| / (atol' + rtol·|want|)`` over a tensor
    or a tuple of them, with ``atol' = atol·max|want|`` when ``scaled``;
    at most 1 passes. The kernels against their plain versions: the
    forward (fp32 lse and label logit, another summation order) at
    ``(1e-3, 1e-4, False)``; dH and dW (dlogits and the result rounded to
    bf16 at the same points, so about one bf16 ulp) at ``(1e-3, 2^-7,
    True)``."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        a, b = a.float(), b.float()
        floor = atol * b.abs().max().item() if scaled else atol
        worst = max(worst, ((a - b).abs() / (floor + rtol * b.abs()))
                    .max().item())
    return worst


@functools.cache
def _entries():
    lib = _support.library(_FWD_NAME)
    groups = lib.ptt_linear_xent_groups
    groups.argtypes = [ctypes.c_int]
    groups.restype = ctypes.c_int
    fwd = lib.ptt_linear_xent_fwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    bwd = lib.ptt_linear_xent_bwd
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return groups, fwd, bwd


def _check_shapes(hidden, weight, labels):
    if hidden.ndim != 2 or weight.ndim != 2 or labels.ndim != 1 \
            or weight.shape[0] != hidden.shape[1] \
            or labels.shape[0] != hidden.shape[0]:
        raise ValueError(f"linear_xent: hidden {tuple(hidden.shape)}, weight "
                         f"{tuple(weight.shape)} and labels "
                         f"{tuple(labels.shape)} are not [N, E], [E, V], [N]")
    if weight.dtype != hidden.dtype or labels.is_floating_point():
        raise TypeError(f"linear_xent: hidden {hidden.dtype} and weight "
                        f"{weight.dtype} must share a type, labels "
                        f"({labels.dtype}) be integers")


def _kernel_inputs(hidden, weight, labels):
    """Checks what the kernels take and returns contiguous ``(h, w,
    int32 labels)``."""
    _check_shapes(hidden, weight, labels)
    if hidden.dtype != torch.bfloat16:
        raise TypeError(f"linear_xent kernels take bfloat16, got "
                        f"{hidden.dtype}")
    return (hidden.contiguous(), weight.contiguous(),
            labels.to(torch.int32).contiguous())


def _rows_fp32(t, n):
    if t.shape != (n,) or t.dtype != torch.float32:
        raise ValueError(f"linear_xent backward: lse and g must be fp32 "
                         f"[{n}], got {tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def _fwd_kernel(hidden, weight, labels):
    """B11: ``(lse [N], sel [N])`` fp32."""
    h, w, lab = _kernel_inputs(hidden, weight, labels)
    n, e = h.shape
    v = w.shape[1]
    groups_of, fwd, _ = _entries()
    part = torch.empty((3, groups_of(v), n), device=h.device,
                       dtype=torch.float32)
    lse = torch.empty((n,), device=h.device, dtype=torch.float32)
    sel = torch.empty_like(lse)
    err = fwd(h.data_ptr(), w.data_ptr(), lab.data_ptr(), part.data_ptr(),
              lse.data_ptr(), sel.data_ptr(), n, e, v, _support.stream_of(h))
    _support.check(err, _FWD_NAME)
    _support.LAUNCHES[_FWD_NAME] += 1
    return lse, sel


def _chunking(v: int):
    """``(chunk width, scratch row length)`` of the backward's walk."""
    vc = min(v, VOCAB_CHUNK)
    return vc, -(-vc // 8) * 8


def _bwd_kernel(hidden, weight, labels, lse, g, want_dh, want_dw):
    """B12 and/or B13 in one walk over the vocabulary: ``(dH [N, E] or
    None, dW [E, V] or None)``, bf16."""
    h, w, lab = _kernel_inputs(hidden, weight, labels)
    n, e = h.shape
    v = w.shape[1]
    lse, g = _rows_fp32(lse, n), _rows_fp32(g, n)
    vc, ldd = _chunking(v)
    dlog = torch.empty((n, ldd), device=h.device, dtype=torch.bfloat16)
    acc = dh = dw = None
    if want_dh:
        acc = torch.empty((n, e), device=h.device, dtype=torch.float32)
        dh = torch.empty_like(h)
    if want_dw:
        dw = torch.empty_like(w)
    outs = [None if t is None else t.data_ptr() for t in (acc, dh, dw)]
    err = _entries()[2](h.data_ptr(), w.data_ptr(), lab.data_ptr(),
                        lse.data_ptr(), g.data_ptr(), dlog.data_ptr(),
                        *outs, n, e, v, vc, ldd, _support.stream_of(h))
    _support.check(err, _DH_NAME if want_dh else _DW_NAME)
    if want_dh:
        _support.LAUNCHES[_DH_NAME] += 1
    if want_dw:
        _support.LAUNCHES[_DW_NAME] += 1
    return dh, dw


def linear_xent_fwd(hidden, weight, labels):
    """B11 on its own: the kernel on CUDA tensors, the plain version on CPU
    tensors. Returns ``(lse, sel)``."""
    if _support.use_kernel(hidden):
        return _fwd_kernel(hidden, weight, labels)
    return linear_xent_fwd_reference(hidden, weight, labels)


def linear_xent_dh(hidden, weight, labels, lse, g):
    """B12 on its own (kernel on CUDA tensors, plain version on CPU)."""
    if _support.use_kernel(hidden):
        return _bwd_kernel(hidden, weight, labels, lse, g, True, False)[0]
    return linear_xent_dh_reference(hidden, weight, labels, lse, g)


def linear_xent_dw(hidden, weight, labels, lse, g):
    """B13 on its own (kernel on CUDA tensors, plain version on CPU)."""
    if _support.use_kernel(hidden):
        return _bwd_kernel(hidden, weight, labels, lse, g, False, True)[1]
    return linear_xent_dw_reference(hidden, weight, labels, lse, g)


class _LinearXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels):
        ctx.kernel = _support.use_kernel(hidden)
        fwd = _fwd_kernel if ctx.kernel else linear_xent_fwd_reference
        lse, sel = fwd(hidden, weight, labels)
        ctx.save_for_backward(hidden, weight, labels, lse)
        return lse - sel

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse = ctx.saved_tensors
        g = g.to(lse.dtype)
        want_dh, want_dw = ctx.needs_input_grad[:2]
        dh = dw = None
        if ctx.kernel:
            dh, dw = _bwd_kernel(hidden, weight, labels, lse, g.contiguous(),
                                 want_dh, want_dw)
        else:
            if want_dh:
                dh = linear_xent_dh_reference(hidden, weight, labels, lse, g)
            if want_dw:
                dw = linear_xent_dw_reference(hidden, weight, labels, lse, g)
        return dh, dw, None


def fused_linear_cross_entropy(hidden, weight, labels):
    """Per-row loss ``lse(h_i·W) − (h_i·W)[labels[i]]`` for hidden [N, E],
    weight [E, V] and integer labels [N], fp32 [N], differentiable in
    hidden and weight; the [N, V] logits are never materialized. A label
    outside ``[0, V)`` selects nothing: its row loss is the bare lse (the
    caller masks it) and it contributes no one-hot term to the
    gradients. The kernels on CUDA tensors (bfloat16; other types raise:
    the kernels have no float32 path yet), the plain versions on CPU
    tensors."""
    _check_shapes(hidden, weight, labels)
    # a tied head's weight is the embedding transposed: one copy a call,
    # as in the JAX package, saved once for both backward kernels
    return _LinearXent.apply(hidden.contiguous(), weight.contiguous(),
                             labels)
