"""Selective scan (the Mamba SSM recurrence), forward and backward: CUDA
kernels (``csrc/selective_scan.cu``), their plain PyTorch versions, and
the autograd wiring.

Replaces ``paddle_tpu/ops/pallas/selective_scan.py:112 _fwd_call``,
``:210 _bwd_call`` and their custom VJP (``:280-298``)::

    h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t u_t B_t,  y_t = ⟨h_t, C_t⟩ + D u_t

u, Δ, y ``[B, T, Ei]``; A ``[Ei, N]``; B, C ``[B, T, N]``; D ``[Ei]``; the
state ``[B, Ei, N]``. All fp32 (the Pallas kernel's type, ``:70-71``): on
a CUDA tensor another type raises. Unlike the Pallas forward, the kernel
also takes an initial state and returns the final one, so that a
prefill runs it with the carried state; the TPU's shape gates (``Ei %
128``, ``N % 8``, ``T % k``) are not inherited: any T and Ei, and N up to
32.

As in the JAX package, the ``D·u`` terms of the backward (``du += D·dy``,
``dD = Σ dy·u``) and the cross-batch sum of the per-batch dA partials stay
outside the kernels, and so does the sum of dB and dC over the channel
blocks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.kernels import _support

__all__ = ["selective_scan", "selective_scan_reference",
           "selective_scan_bwd_reference",
           "save_interval", "mismatch", "MAX_STATE", "CHANNEL_BLOCK"]

_NAME = "selective_scan"
_BWD_NAME = "selective_scan_bwd"
MAX_STATE = 32       # N: the kernels keep ceil(N / 4) states a thread
CHANNEL_BLOCK = 32   # channels a block of the kernels owns
PLAIN_CHUNK = 64     # steps the plain versions vectorise around the loop
LOG2E = 1.4426950408889634


def _cast(ts):
    ct = _support.compute_dtype(ts[0])
    return ct, [None if t is None else t.to(ct) for t in ts]


def _exp(x):
    """exp(x) as the plain versions take it. On a CPU tensor: exp2(x·log2
    e), the kernels' own form (``__expf`` is ``ex2.approx`` of the scaled
    argument), which keeps off ``torch.exp``'s MKL vector-math path: its
    first multithreaded call in a process can return one thread's share
    of the elements with up to 1.5e-4 relative error while XLA:CPU work
    runs beside it (5 first calls in 90, the JAX parity tests' setting;
    ``torch.exp2`` 0 in 90), so the plain scan's first call ran other
    arithmetic than its later ones. On the card ``torch.exp``, which has
    no such path and which ``chip_smoke.py``'s whole-run limits were read
    against."""
    if x.device.type == "cpu":
        return torch.exp2(x * LOG2E)
    return torch.exp(x)


def _chunk_coeffs(u, delta, A, B, sl):
    """exp(Δ·A) and Δ·u·B for the steps ``sl``: [B, k, Ei, N] each."""
    dl = delta[:, sl]
    dA = _exp(dl[..., None] * A)
    dBu = (dl * u[:, sl])[..., None] * B[:, sl, None, :]
    return dA, dBu


def _run(h, dA, dBu):
    """The states after each of the chunk's steps, from ``h`` before it:
    [B, k, Ei, N]."""
    hs = []
    for i in range(dA.shape[1]):
        h = dA[:, i] * h + dBu[:, i]
        hs.append(h)
    return torch.stack(hs, 1)


def selective_scan_reference(u, delta, A, B, C, D, initial_state=None):
    """Plain version: the sequential recurrence, one step at a time over
    T (vectorised over batch, channels and states, and, for the exps and
    products around it, over chunks of ``PLAIN_CHUNK`` steps). fp32 (fp64
    for fp64 inputs). Returns ``(y [B, T, Ei], h_T [B, Ei, N])``."""
    ct, (u, delta, A, B, C, D, h) = _cast(
        [u, delta, A, B, C, D, initial_state])
    nb, T, Ei = u.shape
    if h is None:
        h = torch.zeros(nb, Ei, A.shape[1], dtype=ct, device=u.device)
    ys = []
    for t0 in range(0, T, PLAIN_CHUNK):
        sl = slice(t0, t0 + PLAIN_CHUNK)
        hs = _run(h, *_chunk_coeffs(u, delta, A, B, sl))
        h = hs[:, -1]
        ys.append(torch.einsum("btin,btn->bti", hs, C[:, sl]))
    return torch.cat(ys, 1) + u * D, h


def selective_scan_bwd_reference(u, delta, A, B, C, dy, initial_state=None,
                                 dh_last=None):
    """Plain backward: the explicit reverse adjoint of the Pallas backward
    (``selective_scan.py:160-203``), not autograd through the loop. The
    states are recomputed from ``initial_state`` (the state entering each
    chunk kept, the chunk's own states again in reverse), then
    ``g_t = dy_t C_t + exp(Δ_{t+1} A) g_{t+1}`` (plus ``dh_last`` at the
    last step). Returns ``(du, dΔ, dA_part [B, Ei, N], dB, dC, dh0)``:
    du without the ``D·dy`` term, dA per batch row (summed outside), dh0
    the initial state's gradient."""
    ct, (u, delta, A, B, C, dy, h, m) = _cast(
        [u, delta, A, B, C, dy, initial_state, dh_last])
    nb, T, Ei = u.shape
    N = A.shape[1]
    if h is None:
        h = torch.zeros(nb, Ei, N, dtype=ct, device=u.device)
    if m is None:
        m = torch.zeros(nb, Ei, N, dtype=ct, device=u.device)
    bounds = []
    for t0 in range(0, T, PLAIN_CHUNK):
        bounds.append((t0, h))
        h = _run(h, *_chunk_coeffs(u, delta, A, B,
                                   slice(t0, t0 + PLAIN_CHUNK)))[:, -1]
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA_part = torch.zeros(nb, Ei, N, dtype=ct, device=u.device)
    for t0, hb in reversed(bounds):
        sl = slice(t0, t0 + PLAIN_CHUNK)
        dA, dBu = _chunk_coeffs(u, delta, A, B, sl)
        hpost = _run(hb, dA, dBu)
        hprev = torch.cat([hb[:, None], hpost[:, :-1]], 1)
        dl, uu, dyc = delta[:, sl], u[:, sl], dy[:, sl]
        Bc, Cc = B[:, sl], C[:, sl]
        gs = [None] * dl.shape[1]
        for i in reversed(range(dl.shape[1])):
            g = Cc[:, i, None, :] * dyc[:, i, :, None] + m
            gs[i] = g
            m = dA[:, i] * g
        gs = torch.stack(gs, 1)
        s1 = (gs * Bc[:, :, None, :]).sum(-1)
        du[:, sl] = dl * s1
        gdh = gs * dA * hprev
        ddt[:, sl] = (gdh * A).sum(-1) + uu * s1
        dB[:, sl] = (gs * (dl * uu)[..., None]).sum(2)
        dC[:, sl] = (hpost * dyc[..., None]).sum(2)
        dA_part += (gdh * dl[..., None]).sum(1)
    return du, ddt, dA_part, dB, dC, m


def save_interval(n: int) -> int:
    """The forward kernel's save interval for N states: it writes the
    state entering every such step for the backward. A thread keeps
    ``ceil(N / 4)`` states (2, 4 or 8) and the backward one interval of
    them in 64 registers (``csrc/selective_scan.cu``, which checks the
    count of saved states it is given against the same rule)."""
    for spt in (2, 4, 8):
        if 0 < n <= 4 * spt:
            return 64 // spt
    raise ValueError(f"selective_scan kernel: N={n} states, at most "
                     f"{MAX_STATE}")


@functools.cache
def _fwd_entry():
    fn = _support.library(_NAME).ptt_selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = _support.library(_BWD_NAME).ptt_selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _checked(u, delta, A, B, C, rest):
    """The operands, contiguous, after checking shapes, types and device;
    ``rest`` maps a name to ``(tensor or None, shape)``."""
    nb, T, Ei = u.shape
    N = A.shape[-1]
    want = {"u": (u, (nb, T, Ei)), "delta": (delta, (nb, T, Ei)),
            "A": (A, (Ei, N)), "B": (B, (nb, T, N)), "C": (C, (nb, T, N)),
            **rest}
    out = []
    for name, (t, shape) in want.items():
        if t is None:
            out.append(None)
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan kernel: {name} is {t.dtype}; "
                            "the kernel takes float32")
        if t.device != u.device:
            raise ValueError(f"selective_scan: {name} on {t.device}, u on "
                             f"{u.device}")
        out.append(t.contiguous())
    return out


def _fwd_kernel(u, delta, A, B, C, D, h0=None, *, save: bool = False):
    """The forward kernel: ``(y, saved states [B, T/KS, Ei, N] or None,
    h_T)``."""
    nb, T, Ei = u.shape
    N = A.shape[-1]
    u, delta, A, B, C, D, h0 = _checked(u, delta, A, B, C, {
        "D": (D, (Ei,)), "initial_state": (h0, (nb, Ei, N))})
    ks = save_interval(N)
    nsave = -(-T // ks)
    y = torch.empty_like(u)
    hsave = (torch.empty((nb, nsave, Ei, N), device=u.device,
                         dtype=torch.float32) if save else None)
    hlast = torch.empty((nb, Ei, N), device=u.device, dtype=torch.float32)
    err = _fwd_entry()(u.data_ptr(), delta.data_ptr(), A.data_ptr(),
                       B.data_ptr(), C.data_ptr(), D.data_ptr(), _ptr(h0),
                       y.data_ptr(), _ptr(hsave), hlast.data_ptr(), nb, T,
                       Ei, N, nsave, _support.stream_of(u))
    _support.check(err, _NAME)
    _support.LAUNCHES[_NAME] += 1
    return y, hsave, hlast


def _bwd_kernel(u, delta, A, B, C, hsave, dy, dh_last=None):
    """The backward kernel from the forward kernel's saved states:
    ``(du, dΔ, dA_part, dB, dC, dh0)`` as ``selective_scan_bwd_reference``
    returns them. dB and dC are the kernel's per-channel-block partials
    summed here in block order."""
    nb, T, Ei = u.shape
    N = A.shape[-1]
    nsave = -(-T // save_interval(N))
    u, delta, A, B, C, hsave, dy, dh_last = _checked(u, delta, A, B, C, {
        "saved states": (hsave, (nb, nsave, Ei, N)), "dy": (dy, (nb, T, Ei)),
        "dh_last": (dh_last, (nb, Ei, N))})
    nblk = -(-Ei // CHANNEL_BLOCK)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB_part = torch.empty((nb, nblk, T, N), device=u.device,
                          dtype=torch.float32)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((nb, Ei, N), device=u.device, dtype=torch.float32)
    dh0 = torch.empty_like(dA_part)
    err = _bwd_entry()(u.data_ptr(), delta.data_ptr(), A.data_ptr(),
                       B.data_ptr(), C.data_ptr(), hsave.data_ptr(),
                       dy.data_ptr(), _ptr(dh_last), du.data_ptr(),
                       ddt.data_ptr(), dB_part.data_ptr(),
                       dC_part.data_ptr(), dA_part.data_ptr(),
                       dh0.data_ptr(), nb, T, Ei, N, nsave,
                       _support.stream_of(u))
    _support.check(err, _BWD_NAME)
    _support.LAUNCHES[_BWD_NAME] += 1
    return du, ddt, dA_part, dB_part.sum(1), dC_part.sum(1), dh0


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, h0):
        ctx.kernel = _support.use_kernel(u)
        ctx.set_materialize_grads(False)
        save = any(ctx.needs_input_grad)
        hsave = None
        if ctx.kernel:
            y, hsave, hlast = _fwd_kernel(u, delta, A, B, C, D, h0,
                                          save=save)
        else:
            y, hlast = selective_scan_reference(u, delta, A, B, C, D, h0)
        if save:
            ctx.save_for_backward(u, delta, A, B, C, D, h0, hsave)
        return y, hlast

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, delta, A, B, C, D, h0, hsave = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        if ctx.kernel:
            du, ddt, dA_part, dB, dC, dh0 = _bwd_kernel(
                u, delta, A, B, C, hsave, dy, dh_last)
        else:
            du, ddt, dA_part, dB, dC, dh0 = selective_scan_bwd_reference(
                u, delta, A, B, C, dy, h0, dh_last)
        du = du + dy * D
        dD = (dy * u).sum((0, 1))
        return (du, ddt, dA_part.sum(0), dB, dC, dD,
                None if h0 is None else dh0)


def selective_scan(u, delta, A, B, C, D, *, initial_state=None,
                   return_state: bool = False):
    """The selective scan, differentiable in every input (the initial
    state too): the kernels on CUDA tensors (fp32), the plain versions on
    CPU tensors. Returns y [B, T, Ei], and with ``return_state`` also the
    final state [B, Ei, N]."""
    y, h = _Scan.apply(u, delta, A, B, C, D, initial_state)
    return (y, h) if return_state else y


def mismatch(got, want, rtol: float = 1e-4, atol: float = 1e-4) -> float:
    """How far the kernels' outputs ``got`` lie from the plain versions'
    ``want`` (tensors or tuples of them), as the largest ratio of a
    difference to ``atol·max|want| + rtol·|want|`` over each tensor: 1 or
    less means they agree. Both run the same fp32 recurrence with another
    exp (``__expf``) and other summation orders; the recurrence is a
    contraction (|exp(Δ·A)| <= 1), so rounding differences stay near fp32
    epsilon times the largest value instead of growing with T."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        wf = b.float()
        tol = (atol * wf.abs().max() + rtol * wf.abs()).clamp_min(
            torch.finfo(torch.float32).tiny)
        worst = max(worst, ((a.float() - wf).abs() / tol).max().item())
    return worst
