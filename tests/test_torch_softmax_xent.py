"""Softmax cross-entropy (B14, B15) and the dense loss's surface, the port
against the JAX package on the CPU.

The plain versions (what the kernel wrappers run on CPU tensors) against
the Pallas ``_lse_call`` / ``_dx_call`` in interpret mode and against
``jax.vjp`` of the JAX custom VJP; ``F.softmax_with_cross_entropy`` and
``F.cross_entropy`` against the JAX functions under ``force_dispatch``
(the Pallas path, rows padded and ignore-masked) and off it (the
``log_softmax`` path), soft labels and class weights included; and the
dense Llama loss, which reaches the kernels at V = 256. fp32 within
1e-5 abs/rel: the same log-sum-exp in another summation order; bf16
within one bf16 step of the loss (2^-7 relative) and of the gradient
(2^-8 relative plus 1e-4 of its largest value), both sides rounding the
fp32 result once.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import _support as jax_support

from paddle_tpu_torch import bridge
from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.kernels import softmax_xent as SX
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF

pytestmark = pytest.mark.port

jax_sx = importlib.import_module("paddle_tpu.ops.pallas.softmax_xent")
TOL = dict(rtol=1e-5, atol=1e-5)
IGNORE = -100


def _logits(n, v, seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(n, v) * scale).astype(
        np.float32)


def _labels(n, v, seed=1, ignore_every=0):
    lab = np.random.RandomState(seed).randint(0, v, (n,))
    if ignore_every:
        lab[::ignore_every] = IGNORE
    return lab


def _bf16(a):
    """numpy fp32 → (torch bf16, jnp bf16) holding the same values."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# ------------------------------------------------- the kernels' functions

@pytest.mark.parametrize("n,v", [(128, 256), (8, 512), (256, 2048)])
def test_lse_plain_matches_pallas(n, v):
    x = _logits(n, v)
    with jax_support.force_dispatch():
        want = np.asarray(jax_sx._lse_call(jnp.asarray(x)))[:, 0]
    np.testing.assert_allclose(SX.lse_reference(torch.from_numpy(x)).numpy(),
                               want, **TOL)


def test_lse_plain_matches_pallas_bf16():
    xt, xj = _bf16(_logits(128, 512, seed=2))
    with jax_support.force_dispatch():
        want = np.asarray(jax_sx._lse_call(xj))[:, 0]
    got = SX.lse_reference(xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dx_plain_matches_pallas(dtype):
    n, v = 128, 512
    x = _logits(n, v, seed=3)
    g = np.random.RandomState(4).randn(n).astype(np.float32)
    if dtype == "bfloat16":
        xt, xj = _bf16(x)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    lse = SX.lse_reference(xt)
    lse_b = jnp.broadcast_to(jnp.asarray(lse.numpy())[:, None], (n, 128))
    g_b = jnp.broadcast_to(jnp.asarray(g)[:, None], (n, 128))
    with jax_support.force_dispatch():
        want = np.asarray(jax_sx._dx_call(xj, lse_b, g_b).astype(
            jnp.float32))
    got = SX.dx_reference(xt, lse, torch.from_numpy(g))
    assert got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:       # the same fp32 value rounded once to bf16 on both sides
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_and_vjp_match_jax(dtype):
    """The autograd Function (plain versions) against the JAX custom VJP
    (Pallas in interpret mode): per-row loss and dlogits, the one-hot
    term added outside the kernel on both sides."""
    n, v = 128, 256
    x = _logits(n, v, seed=5)
    lab = _labels(n, v, seed=6)
    g = np.random.RandomState(7).rand(n).astype(np.float32)
    if dtype == "bfloat16":
        xt, xj = _bf16(x)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    with jax_support.force_dispatch():
        want, vjp = jax.vjp(lambda a: jax_sx.softmax_cross_entropy(
            a, jnp.asarray(lab)), xj)
        (want_dx,) = vjp(jnp.asarray(g))
    leaf = xt.clone().requires_grad_()
    got = SX.softmax_cross_entropy(leaf, torch.from_numpy(lab))
    (dx,) = torch.autograd.grad(got, leaf, torch.from_numpy(g))
    assert dx.dtype == xt.dtype
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), want_dx, **TOL)
    else:
        np.testing.assert_allclose(
            dx.float().numpy(), want_dx, rtol=2.0 ** -8,
            atol=1e-4 * np.abs(want_dx).max())


def test_function_refuses_shapes_outside_the_gate():
    with pytest.raises(ValueError, match="gate"):
        SX.softmax_cross_entropy(torch.zeros(8, 100), torch.zeros(8).long())
    with pytest.raises(ValueError, match="gate"):
        SX.softmax_cross_entropy(torch.zeros(12, 256), torch.zeros(12).long())
    assert SX.supported(torch.zeros(136, 256), torch.zeros(136)) is False
    assert SX.supported(torch.zeros(256, 512), torch.zeros(256)) is True
    assert SX.row_pad(130) == 126 and SX.row_pad(12) == 4 \
        and SX.row_pad(128) == 0


# ------------------------------------------- the dense loss's dispatch

@pytest.mark.parametrize("shape", [(3, 7), (2, 64), (1, 130)])
def test_softmax_with_cross_entropy_padded_rows_match_jax(shape):
    """Rows padded to 8 or 128 with ignore_index labels, loss and
    gradient, against the JAX function on its Pallas path."""
    v = 256
    x = _logits(int(np.prod(shape)), v, seed=8).reshape(*shape, v)
    lab = _labels(int(np.prod(shape)), v, seed=9,
                  ignore_every=5).reshape(shape)
    g = np.random.RandomState(10).rand(*shape).astype(np.float32)
    with jax_support.force_dispatch():
        want, vjp = jax.vjp(lambda a: JF.softmax_with_cross_entropy(
            a, jnp.asarray(lab)), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(x).requires_grad_()
    got = TF.softmax_with_cross_entropy(leaf, torch.from_numpy(lab))
    (dx,) = torch.autograd.grad(got, leaf, torch.from_numpy(g))
    assert got.shape == shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
    assert float(got.detach()[torch.from_numpy(lab) == IGNORE].abs().sum()) \
        == 0.0


def test_softmax_with_cross_entropy_bf16_loss_type_matches_jax():
    """bf16 logits: the loss comes back in bf16 on the kernel branch, as
    the JAX package's does (``functional.py:362``)."""
    x = _logits(16, 512, seed=11)
    lab = _labels(16, 512, seed=12, ignore_every=4)
    xt, xj = _bf16(x)
    with jax_support.force_dispatch():
        want = JF.softmax_with_cross_entropy(xj, jnp.asarray(lab))
    got = TF.softmax_with_cross_entropy(xt, torch.from_numpy(lab))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-6)


def test_softmax_with_cross_entropy_takes_the_kernels_inside_the_gate(
        monkeypatch):
    """Inside the gate the loss runs B14 once and, in backward, B15
    once; outside it (V = 300, V = 4096, soft labels, another axis) it
    runs neither. The launches are counted by stand-ins for the launch
    functions that run the plain versions (CPU tensors)."""
    calls = []
    monkeypatch.setattr(_support, "use_kernel", lambda x: True)
    monkeypatch.setattr(SX, "_lse_kernel", lambda x: (
        calls.append("lse"), SX.lse_reference(x))[1])
    monkeypatch.setattr(SX, "_dx_kernel", lambda x, l, g: (
        calls.append("dx"), SX.dx_reference(x, l, g))[1])
    leaf = torch.from_numpy(_logits(10, 256)).requires_grad_()
    TF.cross_entropy(leaf, torch.from_numpy(_labels(10, 256))).backward()
    assert calls == ["lse", "dx"]
    calls.clear()
    for v in (300, 4096):
        TF.cross_entropy(torch.from_numpy(_logits(4, v)),
                         torch.from_numpy(_labels(4, v)))
    soft = torch.softmax(torch.from_numpy(_logits(4, 256)), -1)
    TF.softmax_with_cross_entropy(torch.from_numpy(_logits(4, 256)), soft,
                                  soft_label=True)
    TF.softmax_with_cross_entropy(torch.from_numpy(_logits(256, 4)),
                                  torch.from_numpy(_labels(4, 256)),
                                  axis=0)
    assert calls == []


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_soft_label_matches_jax(reduction):
    rs = np.random.RandomState(13)
    x = (rs.randn(3, 5, 40) * 2).astype(np.float32)
    soft = np.array(jax.nn.softmax(jnp.asarray(rs.randn(3, 5, 40))))
    want = JF.cross_entropy(jnp.asarray(x), jnp.asarray(soft),
                            soft_label=True, reduction=reduction)
    got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(soft),
                           soft_label=True, reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    one = JF.softmax_with_cross_entropy(jnp.asarray(x), jnp.asarray(soft),
                                        soft_label=True)
    np.testing.assert_allclose(
        TF.softmax_with_cross_entropy(torch.from_numpy(x),
                                      torch.from_numpy(soft),
                                      soft_label=True).numpy(),
        np.asarray(one), **TOL)


@pytest.mark.parametrize("soft_label", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_class_weight_matches_jax(soft_label, reduction):
    """A per-class ``weight``: int labels scale each position by its
    label's weight (0 at ignore_index) and "mean" divides by the weights'
    sum; soft labels fold the weights into the inner sum and "mean"
    divides by the total effective weight (``functional.py:373-400``)."""
    rs = np.random.RandomState(14)
    x = (rs.randn(4, 6, 256) * 2).astype(np.float32)
    w = rs.rand(256).astype(np.float32) + 0.5
    if soft_label:
        lab = np.array(jax.nn.softmax(jnp.asarray(rs.randn(4, 6, 256))))
    else:
        lab = rs.randint(0, 256, (4, 6))
        lab[1, ::2] = IGNORE
    want = JF.cross_entropy(jnp.asarray(x), jnp.asarray(lab),
                            soft_label=soft_label, reduction=reduction,
                            weight=jnp.asarray(w))
    got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                           soft_label=soft_label, reduction=reduction,
                           weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ the dense loss

def test_dense_llama_loss_and_grads_match_jax_on_the_kernel_path():
    """``LlamaConfig.tiny()`` (V = 256, dense head): the port's loss and
    every gradient against the JAX loss with its Pallas kernels
    dispatched (``force_dispatch``: B14/B15 in interpret mode, flash and
    the norms' kernels too), 2 × 24 tokens, so the shifted 46 rows pad
    to 48."""
    jm = JaxLlama(JaxConfig.tiny(), key=jax.random.PRNGKey(3))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    ids = np.random.RandomState(15).randint(0, 256, (2, 24)).astype(np.int32)
    with jax_support.force_dispatch():
        want, jgrads = jax.value_and_grad(
            lambda m: m.loss(jnp.asarray(ids), jnp.asarray(ids)))(jm)
    tids = torch.from_numpy(ids).long()
    got = tm.loss(tids, tids)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_g = bridge.from_jax_state_dict(state_dict(jgrads), 2)
    for name, grad in bridge.grads_state_dict(tm).items():
        np.testing.assert_allclose(grad, np.asarray(want_g[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
