"""The port's fused LM head (``kernels/linear_xent.py``) and the head modes
of ``linear_cross_entropy`` against the JAX package, in fp32 on the CPU.

- The three plain versions (forward lse/sel, dH, dW) against the Pallas
  kernels ``_fwd_call`` / ``_dh_call`` / ``_dw_call`` run in interpret
  mode, as ``tests/test_linear_xent.py`` runs them, at shapes their gates
  accept, with a row at -100; the plain versions walk the vocabulary in
  384-wide tiles (one ragged) where the Pallas kernels take their own.
  Forward rtol/atol 1e-5; dH and dW rtol 1e-4, atol 1e-5 (fp32, another
  summation order over E and V).
- ``fused_linear_cross_entropy``'s gradients against ``jax.grad`` of the
  JAX one, same tolerances; its ``autograd.Function`` passes
  ``gradcheck`` in float64.
- ``linear_cross_entropy`` in all four modes and three reductions, N=44
  rows with some at ``ignore_index``, against the JAX function in the
  same mode (on the CPU the JAX ``"fused"`` runs its chunked arm and
  ``"auto"`` its dense arm): values rtol 1e-5, atol 1e-6, and the mean's
  gradients rtol 1e-4, atol 1e-6.
Inputs come from numpy seeds and go to both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.kernels import linear_xent as LX
from paddle_tpu_torch.nn import functional as TF

pytestmark = pytest.mark.port

JLX = importlib.import_module("paddle_tpu.ops.pallas.linear_xent")

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
IGNORE = -100


def _inputs(n, e, v, seed=0):
    rs = np.random.RandomState(seed)
    h = rs.randn(n, e).astype(np.float32)
    w = (0.1 * rs.randn(e, v)).astype(np.float32)
    labels = rs.randint(0, v, n).astype(np.int32)
    labels[1] = IGNORE
    g = rs.rand(n).astype(np.float32)
    return h, w, labels, g


def _t(a):
    return torch.from_numpy(np.asarray(a))


SHAPES = [(24, 128, 384), (256, 128, 256), (512, 256, 1280)]


@pytest.mark.parametrize("n,e,v", SHAPES)
def test_plain_forward_matches_pallas(n, e, v):
    h, w, labels, _ = _inputs(n, e, v)
    lse, sel = LX.linear_xent_fwd_reference(_t(h), _t(w), _t(labels),
                                            block_v=384)
    jlse, jsel = JLX._fwd_call(jnp.asarray(h), jnp.asarray(w),
                               JLX._lane(jnp.asarray(labels), jnp.int32))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0],
                               **FWD_TOL)
    np.testing.assert_allclose(sel.numpy(), np.asarray(jsel)[:, 0],
                               **FWD_TOL)
    assert sel[1] == 0           # the -100 row selects nothing


@pytest.mark.parametrize("which", ["dh", "dw"])
@pytest.mark.parametrize("n,e,v", SHAPES)
def test_plain_backward_matches_pallas(n, e, v, which):
    h, w, labels, g = _inputs(n, e, v, seed=1)
    lse, _ = LX.linear_xent_fwd_reference(_t(h), _t(w), _t(labels))
    args = (_t(h), _t(w), _t(labels), lse, _t(g))
    jargs = (jnp.asarray(h), jnp.asarray(w),
             JLX._lane(jnp.asarray(labels), jnp.int32),
             JLX._lane(jnp.asarray(lse.numpy())), JLX._lane(jnp.asarray(g)))
    if which == "dh":
        got = LX.linear_xent_dh_reference(*args, block_v=384)
        want = JLX._dh_call(*jargs)
    else:
        got = LX.linear_xent_dw_reference(*args, block_v=384)
        want = JLX._dw_call(*jargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("n,e,v", SHAPES[1:])
def test_fused_loss_and_gradients_match_jax(n, e, v):
    h, w, labels, _ = _inputs(n, e, v, seed=2)
    mask = (labels >= 0).astype(np.float32)
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    per = LX.fused_linear_cross_entropy(th, tw, _t(labels))
    loss = (per * _t(mask)).sum() / mask.sum()
    loss.backward()

    def jloss(a, b):
        jper = JLX.fused_linear_cross_entropy(a, b, jnp.asarray(labels))
        return jnp.sum(jper * mask) / jnp.sum(mask)

    want, (gh, gw) = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(h),
                                                       jnp.asarray(w))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), **GRAD_TOL)
    assert not th.grad[1].any()  # ignored row: zero cotangent, no one-hot


def test_fused_function_gradcheck():
    g = torch.Generator().manual_seed(3)
    h = torch.randn(6, 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(8, 11, generator=g, dtype=torch.float64,
                    requires_grad=True)
    labels = torch.tensor([3, -100, 10, 0, 7, 11])   # 11 is past V - 1
    assert torch.autograd.gradcheck(
        lambda a, b: LX.fused_linear_cross_entropy(a, b, labels), (h, w))


MODES = ["fused", "chunked", "dense", "auto"]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("mode", MODES)
def test_linear_cross_entropy_modes_match_jax(mode, reduction):
    rs = np.random.RandomState(4)
    h = rs.randn(4, 11, 32).astype(np.float32)
    w = (0.2 * rs.randn(32, 300)).astype(np.float32)
    label = rs.randint(0, 300, (4, 11))
    label[0, 3:7] = IGNORE
    label[2, -1] = IGNORE
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    got = TF.linear_cross_entropy(th, tw, _t(label), reduction=reduction,
                                  mode=mode)

    def jfn(a, b):
        return JF.linear_cross_entropy(a, b, jnp.asarray(label),
                                       reduction=reduction, mode=mode)

    want = jfn(jnp.asarray(h), jnp.asarray(w))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    if reduction == "mean":
        got.backward()
        gh, gw = jax.grad(jfn, (0, 1))(jnp.asarray(h), jnp.asarray(w))
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw),
                                   rtol=1e-4, atol=1e-6)


def test_chunked_ragged_tail_matches_jax():
    """Chunks of 128 over V=300: two whole chunks and a ragged 44."""
    h, w, labels, _ = _inputs(40, 64, 300, seed=5)
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    got = TF.chunked_linear_cross_entropy(th, tw, _t(labels), block_v=128)
    got.mean().backward()

    def jfn(a, b):
        return JLX.chunked_linear_cross_entropy(a, b, jnp.asarray(labels),
                                                block_v=128)

    want = jfn(jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    gh, gw = jax.grad(lambda a, b: jnp.mean(jfn(a, b)), (0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), **GRAD_TOL)


def test_cpu_modes_pick_their_arm(monkeypatch):
    """On CPU tensors ``fused`` runs the Function's plain versions,
    ``auto`` the dense head and ``chunked`` neither; no kernel counts."""
    calls = []
    plain = LX.linear_xent_fwd_reference

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(LX, "linear_xent_fwd_reference", counted)
    _support.reset_launches()
    h, w, labels, _ = _inputs(10, 16, 50, seed=6)
    seen = {}
    for mode in MODES:
        calls.clear()
        TF.linear_cross_entropy(_t(h), _t(w), _t(labels), mode=mode)
        seen[mode] = len(calls)
    assert seen == {"fused": 1, "chunked": 0, "dense": 0, "auto": 0}
    assert all(n == 0 for n in _support.LAUNCHES.values())
    with pytest.raises(ValueError):
        TF.linear_cross_entropy(_t(h), _t(w), _t(labels), mode="bogus")


def test_kernel_wrappers_take_bf16_only_and_check_shapes(monkeypatch):
    """Where the kernels would run they take bfloat16 [N, E], [E, V], [N]
    or raise, and the fused head mode raises with them: no quiet
    fallback to another head."""
    h, w, labels, _ = (_t(a) for a in _inputs(8, 16, 24))
    with pytest.raises(TypeError, match="bfloat16"):
        LX._fwd_kernel(h, w, labels)
    with pytest.raises(ValueError):
        LX._fwd_kernel(h.bfloat16(), w.bfloat16()[:, :5].T, labels)
    with pytest.raises(TypeError):
        LX.fused_linear_cross_entropy(h, w.double(), labels)
    with pytest.raises(ValueError):
        LX.fused_linear_cross_entropy(h, w, labels[:3])
    monkeypatch.setattr(_support, "use_kernel", lambda x: True)
    with pytest.raises(TypeError, match="bfloat16"):
        TF.linear_cross_entropy(h, w, labels, mode="fused")
    assert not any(_support.LAUNCHES.values())


@pytest.mark.parametrize("which", ["fwd", "dh", "dw"])
def test_head_check_catches_planted_faults(which):
    """``linear_xent.mismatch`` at the tolerances the kernels are held to
    on the card: the bf16 plain version passes against itself run in
    another vocab tiling, and the same version with one term taken out
    (label logit; one-hot term; softmax term) fails."""
    g = torch.Generator().manual_seed(7)
    h = torch.randn(96, 64, generator=g).bfloat16()
    w = (0.05 * torch.randn(64, 700, generator=g)).bfloat16()
    lab = torch.randint(0, 700, (96,), generator=g)
    lab[::7] = IGNORE
    gr = torch.rand(96, generator=g)
    lse, _ = LX.linear_xent_fwd_reference(h, w, lab)
    plain = {"fwd": LX.linear_xent_fwd_reference,
             "dh": LX.linear_xent_dh_reference,
             "dw": LX.linear_xent_dw_reference}[which]
    extra = () if which == "fwd" else (lse, gr)
    tol = (1e-3, 1e-4, False) if which == "fwd" else (1e-3, 2.0 ** -7, True)
    want = plain(h, w, lab, *extra)
    assert LX.mismatch(plain(h, w, lab, *extra, block_v=128), want,
                       *tol) <= 1
    no_labels = torch.full_like(lab, IGNORE)
    faults = [plain(h, w, no_labels, *extra)]
    if extra:
        faults.append(plain(h, w, lab, torch.full_like(lse, float("inf")),
                            gr))
    for bad in faults:
        assert LX.mismatch(bad, want, *tol) > 1
