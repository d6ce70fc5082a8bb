"""The port's kernel modules against the JAX package, in fp32 on the CPU.

For each kernel the port's plain version (what its wrapper runs on a CPU
tensor) is held against the Pallas kernel, run in interpret mode under
``force_dispatch`` as ``tests/test_decode_attention.py`` runs it, at shapes
its gates accept (D=64, T=128, S=128), and against the JAX package's plain
arm. Tolerance 2e-5 abs/rel: both sides compute in fp32, in another
summation order. Inputs come from a numpy seed and go to both sides.

The backward kernels' plain versions (flash dq/dk/dv, RMSNorm dx/dw,
LayerNorm dx/dw/db, RoPE with ``sign=-1``) are held against ``jax.vjp``
of the Pallas functions, and the AdamW plain version against the Pallas
``adamw_update`` over several steps. Each ``autograd.Function`` passes ``gradcheck`` in float64.

The CUDA kernels themselves run only on the card:
``tests/test_torch_card.py`` (no JAX import, so it runs on the card's
host) holds each against its plain version there and skips without a
GPU.
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import _common as jax_common
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import _support as jax_support
from paddle_tpu.ops.pallas import adamw as jax_adamw
from paddle_tpu.ops.pallas import decode_attention as jax_decode
from paddle_tpu.ops.pallas import norm as jax_norm
from paddle_tpu.ops.pallas import rope as jax_rope

from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.kernels import adamw as A
from paddle_tpu_torch.kernels import decode_attention as DA
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import norm as N
from paddle_tpu_torch.kernels import rope as R
from paddle_tpu_torch.nn import functional as TF
from test_torch_card import ADAMW_STEP, _adamw_state

pytestmark = pytest.mark.port

# the package re-exports the function under the module's name
jax_flash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tables(T, D, offset=0):
    pos = np.arange(T) + offset
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2, dtype=np.float32) / D))
    ang = (pos[:, None] * inv).astype(np.float32)
    return np.cos(ang), np.sin(ang)


# ---------------------------------------------------------------- rms_norm

@pytest.mark.parametrize("rows", [256, 4])
def test_rms_norm_matches_pallas_and_plain(rows):
    x, w = _np(rows, 128), _np(128, seed=1)
    got = N.rms_norm(_t(x), _t(w), 1e-5).numpy()
    if rows % 8 == 0:
        with jax_support.force_dispatch():
            assert jax_norm.supported(jnp.asarray(x), jnp.asarray(w))
            pallas = jax_norm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    plain = JF.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(got, np.asarray(plain), **TOL)


def test_rms_norm_leading_axes_and_default_eps():
    x, w = _np(2, 3, 64), _np(64, seed=1)
    got = TF.rms_norm(_t(x), _t(w)).numpy()
    want = JF.rms_norm(jnp.asarray(x), jnp.asarray(w))
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# -------------------------------------------------------------- layer_norm

@pytest.mark.parametrize("rows,h", [(256, 128), (16, 256), (4, 128)])
def test_layer_norm_matches_pallas_and_plain(rows, h):
    """y, mean and rstd against the Pallas ``_ln_fwd`` (interpret mode)
    where its gate takes the shape, and y against the JAX plain arm
    everywhere (GPT's decode step has 4 rows, which the gate refuses)."""
    x, w, b = _np(rows, h, seed=h), _np(h, seed=1), _np(h, seed=2)
    y, mean, rstd = N.layer_norm_reference(_t(x), _t(w), _t(b), 1e-5,
                                           return_stats=True)
    assert torch.equal(N.layer_norm(_t(x), _t(w), _t(b), 1e-5), y)
    xj, wj, bj = (jnp.asarray(a) for a in (x, w, b))
    if rows % 8 == 0:
        with jax_support.force_dispatch():
            assert jax_norm.supported(xj, wj, bj)
            pallas = jax_norm.layer_norm(xj, wj, bj, 1e-5)
            _, jmean, jrstd = jax_norm._ln_fwd(xj, wj, bj, 1e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **TOL)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0],
                                   **TOL)
        np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0],
                                   **TOL)
    else:
        with jax_support.force_dispatch():
            assert not jax_norm.supported(xj, wj, bj)
    plain = JF.layer_norm(xj, wj, bj, 1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(plain), **TOL)


def test_layer_norm_leading_axes_and_defaults():
    """[B, T, E] input, default epsilon, and no weight or bias (ones and
    zeros) against the JAX plain arm."""
    x = _np(2, 3, 64)
    got = TF.layer_norm(_t(x)).numpy()
    want = JF.layer_norm(jnp.asarray(x))
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("rows,h", [(256, 128), (16, 256)])
def test_layer_norm_bwd_matches_pallas_vjp(rows, h):
    """dx, dw and db of the plain backward (from the port's statistics)
    and of the autograd.Function against jax.vjp of the Pallas
    LayerNorm."""
    x, w, b = _np(rows, h, seed=21), _np(h, seed=22), _np(h, seed=23)
    g = _np(rows, h, seed=24)
    with jax_support.force_dispatch():
        want = _vjp(lambda a, c, d: jax_norm.layer_norm(a, c, d, 1e-5),
                    (x, w, b), g)
    _, mean, rstd = N.layer_norm_reference(_t(x), _t(w), _t(b), 1e-5,
                                           return_stats=True)
    got = N.layer_norm_bwd_reference(_t(x), _t(w), mean, rstd, _t(g))
    assert got[1].dtype == got[2].dtype == torch.float32
    leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    auto = torch.autograd.grad(N.layer_norm(*leaves, 1e-5), leaves, _t(g))
    for name, a, c, ref in zip(("dx", "dw", "db"), got, auto, want):
        tol = TOL if name == "dx" else dict(rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(a.numpy(), ref, err_msg=name, **tol)
        np.testing.assert_allclose(c.numpy(), ref, err_msg=name, **tol)


def test_layer_norm_bwd_ragged_matches_plain_arm_vjp():
    """Any row count and width (the CUDA kernel has no gate): gradients
    against jax.vjp of the JAX plain arm at [3, 5, 40]."""
    x, w, b = _np(3, 5, 40, seed=25), _np(40, seed=26), _np(40, seed=27)
    g = _np(3, 5, 40, seed=28)
    want = _vjp(lambda a, c, d: JF.layer_norm(a, c, d, 1e-5), (x, w, b), g)
    leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    got = torch.autograd.grad(TF.layer_norm(*leaves, 1e-5), leaves, _t(g))
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a.numpy(), ref, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_mismatch_tells_faults_apart(dtype):
    """The checks the card holds B6 and B7 to pass the plain versions
    computed in float64 and rounded, and fail the planted faults: the
    forward without its bias, the backward's dw without x̂, db left out,
    dx without its mean(w·g) term."""
    gen = torch.Generator().manual_seed(29)
    x, w, b, g = (torch.randn(*s, generator=gen).to(dtype)
                  for s in ((300, 776), (776,), (776,), (300, 776)))
    y, mean, rstd = N.layer_norm_reference(x, w, b, return_stats=True)
    y64 = N.layer_norm_reference(x.double(), w.double(), b.double())
    assert N.layer_norm_mismatch(x, w, b, y64.to(dtype), y) <= 1
    no_bias = N.layer_norm_reference(x, w, torch.zeros_like(b))
    assert N.layer_norm_mismatch(x, w, b, no_bias, y) > 1
    want = N.layer_norm_bwd_reference(x, w, mean, rstd, g)
    d64 = N.layer_norm_bwd_reference(x.double(), w.double(), mean.double(),
                                     rstd.double(), g.double())
    exact = (d64[0].to(dtype), d64[1].float(), d64[2].float())
    assert N.layer_norm_bwd_mismatch(x, w, mean, rstd, g, exact, want) <= 1
    r = rstd[:, None]
    xhat = (x.float() - mean[:, None]) * r
    wg = g.float() * w.float()
    c2 = (wg * xhat).mean(-1, keepdim=True)
    for bad in ((want[0], g.float().sum(0), want[2]),
                (want[0], want[1], torch.zeros_like(want[2])),
                ((r * (wg - xhat * c2)).to(dtype), want[1], want[2])):
        assert N.layer_norm_bwd_mismatch(x, w, mean, rstd, g, bad, want) > 1


def test_layer_norm_cpu_tensors_take_plain_version_and_do_not_count():
    _support.reset_launches()
    x, w, b = _t(_np(4, 64)), _t(_np(64, seed=1)), _t(_np(64, seed=2))
    _, mean, rstd = N.layer_norm_reference(x, w, b, return_stats=True)
    N.layer_norm(x, w, b)
    N.layer_norm_bwd(x, w, mean, rstd, x)
    assert all(n == 0 for n in _support.LAUNCHES.values())


# ------------------------------------------------ gelu, dropout, masked sdpa

@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches_jax(approximate):
    x = _np(5, 64) * 3
    got = TF.gelu(_t(x), approximate=approximate).numpy()
    want = JF.gelu(jnp.asarray(x), approximate=approximate)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_dropout_draws_from_the_generator_only():
    """Inverted dropout: kept values scaled by 1/(1-p), the keep share
    near 1-p, the same mask from the same generator seed, identity in
    eval or at p=0, and a ValueError without a generator."""
    x = torch.ones(200, 300)
    a = TF.dropout(x, 0.25, generator=torch.Generator().manual_seed(3))
    b = TF.dropout(x, 0.25, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert TF.dropout(x, 0.25, training=False) is x
    assert TF.dropout(x, 0.0) is x
    with pytest.raises(ValueError, match="Generator"):
        TF.dropout(x, 0.25)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_matches_jax_einsum_arm(causal):
    """With a mask the port runs the JAX einsum arm in torch ops: a
    boolean keep-mask [B, 1, 1, T] (and GQA heads) against the JAX
    function given the same mask."""
    q, k, v = (_np(2, 9, 4, 64), _np(2, 9, 2, 64, seed=1),
               _np(2, 9, 2, 64, seed=2))
    mask = np.ones((2, 1, 1, 9), bool)
    mask[0, ..., 6:] = False
    got = TF.scaled_dot_product_attention(_t(q), _t(k), _t(v), _t(mask),
                                          causal=causal).numpy()
    want = JF.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_all_ones_mask_equals_the_flash_path():
    q, k, v = (_t(_np(2, 9, 4, 64)), _t(_np(2, 9, 4, 64, seed=1)),
               _t(_np(2, 9, 4, 64, seed=2)))
    ones = torch.ones(2, 1, 1, 9, dtype=torch.bool)
    np.testing.assert_allclose(
        TF.scaled_dot_product_attention(q, k, v, ones).numpy(),
        TF.scaled_dot_product_attention(q, k, v).numpy(), **TOL)


# -------------------------------------------------------------------- rope

@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_rope_matches_pallas(sign):
    x = _np(2, 128, 4, 64)
    cos, sin = _tables(128, 64)
    got = R.apply_rotary(_t(x), _t(cos), _t(sin), sign=sign).numpy()
    with jax_support.force_dispatch():
        want = jax_rope._rope_call(jnp.asarray(x), jnp.asarray(cos),
                                   jnp.asarray(sin), sign)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("T,offset", [(128, 0), (1, 37), (5, 100)])
def test_rope_matches_plain(T, offset):
    x = _np(2, T, 4, 64, seed=T)
    cos, sin = _tables(T, 64, offset)
    got = R.apply_rotary(_t(x), _t(cos), _t(sin)).numpy()
    want = JF.apply_rotary(jnp.asarray(x), jnp.asarray(cos),
                           jnp.asarray(sin))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_rope_tables_match():
    pos = np.arange(7) + 3
    tc, ts = TF.rotary_embedding(torch.from_numpy(pos), 64)
    jc, js = JF.rotary_embedding(jnp.asarray(pos), 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_rope_inverse_rotation_restores_input():
    x = _np(1, 9, 2, 64)
    cos, sin = _tables(9, 64)
    y = R.apply_rotary(_t(x), _t(cos), _t(sin))
    back = R.apply_rotary(y, _t(cos), _t(sin), sign=-1.0).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5)


# ---------------------------------------------------------- flash attention

@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_flash_matches_pallas(Hq, Hkv):
    q, k, v = (_np(1, 128, Hq, 64), _np(1, 128, Hkv, 64, seed=1),
               _np(1, 128, Hkv, 64, seed=2))
    got, lse = FA.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                  return_lse=True)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    with jax_support.force_dispatch():
        assert jax_flash.supported(qj, kj, vj, causal=True)
        want = jax_flash.flash_attention(qj, kj, vj, causal=True)
        _, want_lse = jax_flash._fwd(
            qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
            vj.transpose(0, 2, 1, 3), True, 0.125, None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", [(37, 37), (5, 20)])
def test_flash_matches_plain_ragged(causal, Tq, Tk):
    """Ragged lengths and the Tk - Tq causal offset against the JAX
    einsum arm (which has no length gate)."""
    q, k, v = (_np(2, Tq, 4, 64), _np(2, Tk, 2, 64, seed=1),
               _np(2, Tk, 2, 64, seed=2))
    got = TF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          causal=causal).numpy()
    want = JF.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        use_pallas="never")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_flash_rejects_causal_with_more_queries_than_keys():
    q, k = _t(_np(1, 8, 2, 64)), _t(_np(1, 4, 2, 64))
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, k, causal=True)


# ----------------------------------------------------------------- backward

def _vjp(fn, inputs, cotangent):
    out, pull = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return [np.asarray(g) for g in pull(jnp.asarray(cotangent))]


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_flash_bwd_matches_pallas_vjp(Hq, Hkv):
    """dq, dk, dv of the plain backward (from the port's o and lse) and of
    the autograd.Function against jax.vjp of the Pallas kernels."""
    q, k, v = (_np(1, 128, Hq, 64, seed=3), _np(1, 128, Hkv, 64, seed=4),
               _np(1, 128, Hkv, 64, seed=5))
    do = _np(1, 128, Hq, 64, seed=6)
    with jax_support.force_dispatch():
        want = _vjp(lambda a, b, c: jax_flash.flash_attention(
            a, b, c, causal=True), (q, k, v), do)
    o, lse = FA.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                return_lse=True)
    got = FA.flash_attention_bwd_reference(_t(q), _t(k), _t(v), o, lse,
                                           _t(do), causal=True)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    auto = torch.autograd.grad(FA.flash_attention(*leaves, causal=True),
                               leaves, _t(do))
    for g, a, w in zip(got, auto, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        np.testing.assert_allclose(a.numpy(), w, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", [(37, 37), (5, 20)])
def test_flash_bwd_ragged_matches_plain_arm_vjp(causal, Tq, Tk):
    """Ragged lengths and the Tk - Tq causal offset, gradients against
    jax.vjp of the JAX einsum arm."""
    q, k, v = (_np(2, Tq, 4, 64, seed=7), _np(2, Tk, 2, 64, seed=8),
               _np(2, Tk, 2, 64, seed=9))
    do = _np(2, Tq, 4, 64, seed=10)
    want = _vjp(lambda a, b, c: JF.scaled_dot_product_attention(
        a, b, c, causal=causal, use_pallas="never"), (q, k, v), do)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(TF.scaled_dot_product_attention(
        *leaves, causal=causal), leaves, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_rms_norm_bwd_matches_pallas_vjp():
    x, w, g = _np(256, 128, seed=11), _np(128, seed=12), _np(256, 128,
                                                             seed=13)
    with jax_support.force_dispatch():
        want = _vjp(lambda a, b: jax_norm.rms_norm(a, b, 1e-5), (x, w), g)
    _, rstd = N.rms_norm_reference(_t(x), _t(w), 1e-5, return_rstd=True)
    dx, dw = N.rms_norm_bwd_reference(_t(x), _t(w), rstd, _t(g))
    assert dw.dtype == torch.float32 and rstd.shape == (256,)
    np.testing.assert_allclose(dx.numpy(), want[0], **TOL)
    np.testing.assert_allclose(dw.numpy(), want[1], rtol=2e-5, atol=1e-4)
    leaves = [_t(x).requires_grad_(), _t(w).requires_grad_()]
    auto = torch.autograd.grad(N.rms_norm(*leaves, 1e-5), leaves, _t(g))
    np.testing.assert_allclose(auto[0].numpy(), want[0], **TOL)
    np.testing.assert_allclose(auto[1].numpy(), want[1], rtol=2e-5,
                               atol=1e-4)


def test_rope_backward_is_the_sign_flip_of_pallas():
    x, g = _np(2, 128, 4, 64, seed=14), _np(2, 128, 4, 64, seed=15)
    cos, sin = _tables(128, 64)
    with jax_support.force_dispatch():
        want = _vjp(lambda a: jax_rope.apply_rotary(
            a, jnp.asarray(cos), jnp.asarray(sin)), (x,), g)[0]
    leaf = _t(x).requires_grad_()
    got = torch.autograd.grad(R.apply_rotary(leaf, _t(cos), _t(sin)), leaf,
                              _t(g))[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        R.apply_rotary_reference(_t(g), _t(cos), _t(sin), -1.0).numpy(),
        want, **TOL)


@pytest.mark.parametrize("p_dtype", [np.float32, "bfloat16"])
def test_adamw_reference_matches_pallas_over_steps(p_dtype):
    """Four steps of the in-place plain version against the Pallas
    ``adamw_update`` (interpret mode), fp32 moments, bf16 or fp32 p."""
    rs = np.random.RandomState(16)
    p0 = rs.randn(37, 29).astype(np.float32)
    jp = jnp.asarray(p0, dtype=jnp.bfloat16 if p_dtype == "bfloat16"
                     else jnp.float32)
    jm = jv = jnp.zeros(p0.shape, jnp.float32)
    tp = torch.from_numpy(np.array(jp.astype(jnp.float32))).to(
        torch.bfloat16 if p_dtype == "bfloat16" else torch.float32)
    tm, tv = torch.zeros(p0.shape), torch.zeros(p0.shape)
    for step in range(1, 5):
        g = rs.randn(*p0.shape).astype(np.float32) * 0.1
        kw = dict(lr=1e-2 * step, beta1=0.9, beta2=0.99, eps=1e-8,
                  weight_decay=0.1, step=step)
        jp, jm, jv = jax_adamw.adamw_update(jp, jm, jv, jnp.asarray(g), **kw)
        A.adamw_update(tp, tm, tv, torch.from_numpy(g), **kw)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tp.float().numpy(),
                               np.asarray(jp.astype(jnp.float32)),
                               **(TOL if p_dtype == np.float32
                                  else dict(rtol=8e-3, atol=0)))


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_adamw_mismatch_tells_wrong_steps_apart(p_dtype, monkeypatch):
    """The tolerance the card holds the AdamW kernel to
    (``update_mismatch``) passes the step computed in float64 and rounded,
    and fails a step that writes nothing or drops the bias corrections."""
    before, g = _adamw_state((64, 300), p_dtype,
                             torch.Generator().manual_seed(5), "cpu")

    def step(dtype=None):
        state = [t.clone() if dtype is None else t.to(dtype) for t in before]
        return A.adamw_update_reference(
            *state, g if dtype is None else g.to(dtype), **ADAMW_STEP)

    want = step()
    p64, m64, v64 = step(torch.float64)
    exact = (p64.to(p_dtype), m64.float(), v64.float())
    assert A.update_mismatch(before, g, want, want, **ADAMW_STEP) == 0
    assert A.update_mismatch(before, g, exact, want, **ADAMW_STEP) <= 1
    assert A.update_mismatch(before, g, before, want, **ADAMW_STEP) > 1  # no-op
    monkeypatch.setattr(A, "_bias_corrections", lambda b1, b2, s: (1.0, 1.0))
    assert A.update_mismatch(before, g, step(), want, **ADAMW_STEP) > 1


@pytest.mark.parametrize("case", ["flash_causal_gqa", "flash_full",
                                  "rms_norm", "layer_norm", "rope"])
def test_autograd_function_gradcheck(case):
    """Each autograd.Function's backward (the plain one on the CPU)
    against finite differences, float64."""
    g = torch.Generator().manual_seed(17)

    def rn(*s):
        return torch.randn(*s, generator=g, dtype=torch.float64,
                           requires_grad=True)

    if case.startswith("flash"):
        q, k, v = rn(1, 5, 4, 8), rn(1, 7, 2, 8), rn(1, 7, 2, 8)
        causal = case == "flash_causal_gqa"
        ok = torch.autograd.gradcheck(lambda a, b, c: FA.flash_attention(
            a, b, c, causal=causal), (q, k, v))
    elif case == "rms_norm":
        ok = torch.autograd.gradcheck(lambda a, b: N.rms_norm(a, b, 1e-5),
                                      (rn(3, 4, 16), rn(16)))
    elif case == "layer_norm":
        ok = torch.autograd.gradcheck(
            lambda a, b, c: N.layer_norm(a, b, c, 1e-5),
            (rn(3, 4, 16), rn(16), rn(16)))
    else:
        cos, sin = (torch.rand(5, 4, generator=g, dtype=torch.float64)
                    for _ in range(2))
        ok = torch.autograd.gradcheck(lambda a: R.apply_rotary(a, cos, sin),
                                      (rn(2, 5, 3, 8),))
    assert ok


# --------------------------------------------------------- decode attention

def _decode_inputs(Hq, Hkv, L=2, S=128, seed=0):
    return (_np(2, 1, Hq, 64, seed=seed), _np(2, Hkv, 1, 64, seed=seed + 1),
            _np(2, Hkv, 1, 64, seed=seed + 2),
            (_np(L, 2, Hkv, S, 64, seed=seed + 3),
             _np(L, 2, Hkv, S, 64, seed=seed + 4)))


@pytest.mark.parametrize("idx", [1, 37, 127])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_decode_matches_pallas(idx, Hq, Hkv):
    q, kn, vn, cache = _decode_inputs(Hq, Hkv, seed=idx)
    got = DA.decode_attention(_t(q), _t(kn), _t(vn),
                              tuple(_t(c) for c in cache), 1, idx).numpy()
    jc = tuple(jnp.asarray(c) for c in cache)
    with jax_support.force_dispatch():
        assert jax_decode.supported(jnp.asarray(q), jc)
        want = jax_decode.decode_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jc,
            jnp.int32(1), jnp.int32(idx), scale=0.125)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [1, 3])
def test_cached_attention_matches_plain_arm(T):
    """The port's cached_attention (decode plain version at T=1, the
    chunked einsum arm at T=3) against the JAX package's einsum arm."""
    from paddle_tpu_torch.models import _common as port_common
    q, k, v = _np(2, T, 4, 64), _np(2, T, 2, 64, seed=1), \
        _np(2, T, 2, 64, seed=2)
    cache = (_np(2, 2, 2, 100, 64, seed=3), _np(2, 2, 2, 100, 64, seed=4))
    got, payload = port_common.cached_attention(
        _t(q), _t(k), _t(v), tuple(_t(c) for c in cache), 61, layer=1)
    want, jpay = jax_common.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        tuple(jnp.asarray(c) for c in cache), 61, layer=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in zip(payload, jpay):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cached_attention_chunk_past_index_raises_where_kernels_run(
        monkeypatch):
    """A multi-token chunk at index > 0 (chunked prefill, a prefix-cache
    hit) takes the JAX package's einsum arm where the wrappers would
    launch kernels too (the JAX package runs no kernel there either): it
    no longer raises, it launches nothing (B9's counter stays put), and it
    matches the JAX arm within TOL."""
    from paddle_tpu_torch.models import _common as port_common
    monkeypatch.setattr(_support, "use_kernel", lambda x: True)
    q, k = _np(1, 3, 2, 64), _np(1, 3, 2, 64, seed=1)
    cache = (_np(1, 1, 2, 16, 64, seed=2),) * 2
    _support.reset_launches()
    got, _ = port_common.cached_attention(_t(q), _t(k), _t(k),
                                          tuple(map(_t, cache)), 5, layer=0)
    assert all(n == 0 for n in _support.LAUNCHES.values())
    want, _ = jax_common.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
        tuple(map(jnp.asarray, cache)), 5, layer=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _int8_inputs(Hq, Hkv, L=2, S=128, seed=0):
    """q, k_new, v_new and an int8 cache quantized (the port's
    ``_quant_chunk``) from random k/v whose per-position magnitudes spread
    over 0.3-3."""
    from paddle_tpu_torch.models._common import _quant_chunk
    q, kn, vn, (kc, vc) = _decode_inputs(Hq, Hkv, L=L, S=S, seed=seed)
    spread = 0.3 + 2.7 * np.random.RandomState(seed + 9).rand(
        L, 2, Hkv, S, 1).astype(np.float32)
    (kq, ks), (vq, vs) = (_quant_chunk(_t(c * spread)) for c in (kc, vc))
    return q, kn, vn, (kq, vq, ks, vs)


def test_quant_chunk_matches_jax():
    """Absmax int8: the same int8 values and fp32 scales, bit for bit,
    including a zero row (scale floor 1e-8) and halves (round to even)."""
    from paddle_tpu_torch.models._common import _quant_chunk
    x = _np(2, 3, 5, 64, seed=11) * 4
    x[0, 0, 0] = 0.0
    x[1, 2, 1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[1, 2, 1, 6:] = 0.25
    got = _quant_chunk(_t(x))
    want = jax_common._quant_chunk(jnp.asarray(x))
    for a, b in zip(got, want):
        assert str(a.dtype)[6:] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0][1, 2, 1, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("idx", [1, 37, 127])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_int8_decode_matches_pallas(idx, Hq, Hkv):
    """The int8 plain version against the Pallas kernel's int8 layout
    (``raw_call`` under ``force_dispatch``), fp32 q: both fold the k scale
    into the logits and the v scale into the probabilities."""
    q, kn, vn, cache = _int8_inputs(Hq, Hkv, seed=idx)
    got = DA.decode_attention(_t(q), _t(kn), _t(vn), cache, 1, idx).numpy()
    jc = tuple(jnp.asarray(c.numpy()) for c in cache)
    with jax_support.force_dispatch():
        assert jax_decode.supported(jnp.asarray(q), jc)
        want = jax_decode.decode_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jc,
            jnp.int32(1), jnp.int32(idx), scale=0.125)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_int8_decode_bf16_matches_pallas():
    """bf16 q: the probabilities times the v scale are rounded to bf16
    before the product with v in both (at S = 128 the Pallas kernel's one
    cache block sees the final maximum, so the roundings fall alike).
    Held at two bf16 ulps of the output (2^-7 relative plus 2^-7 of the
    largest value): the fp32 sums run in another order and the output is
    rounded to bf16."""
    q, kn, vn, cache = _int8_inputs(8, 2, seed=3)
    qb, knb, vnb = (_t(a).bfloat16() for a in (q, kn, vn))
    got = DA.decode_attention(qb, knb, vnb, cache, 0, 100).float().numpy()
    jc = tuple(jnp.asarray(c.numpy()) for c in cache)
    with jax_support.force_dispatch():
        want = jax_decode.decode_attention(
            *(jnp.asarray(a.float().numpy(), jnp.bfloat16)
              for a in (qb, knb, vnb)), jc, jnp.int32(0), jnp.int32(100),
            scale=0.125)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def test_int8_decode_against_the_einsum_arm():
    """The JAX einsum arm dequantizes k and v to bf16 (the scale rounded
    too) and takes bf16 logits before its softmax; the port follows the
    Pallas kernel, which folds the scales in fp32. In bf16 the two differ
    by the arm's rounding of logits of size ~3 (2^-8 of them, ~0.01) and
    of the dequantized values: held at 0.05 of the largest output value,
    which each planted fault misses (a v scale left out, scales per head
    instead of per position)."""
    q, kn, vn, cache = _int8_inputs(8, 2, seed=4)
    qb, knb, vnb = (_t(a).bfloat16() for a in (q, kn, vn))
    got = DA.decode_attention(qb, knb, vnb, cache, 1, 90).float()
    jq = jnp.asarray(qb.float().numpy(), jnp.bfloat16)
    jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16).transpose(
        0, 2, 1, 3) for a in (knb, vnb))
    want, _ = jax_common.cached_attention(
        jq, jk, jv, tuple(jnp.asarray(c.numpy()) for c in cache), 90,
        layer=1)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    limit = 0.05 * want.abs().max().item()
    assert (got - want).abs().max().item() <= limit
    kq, vq, ks, vs = cache
    per_head = [s.amax(-1, keepdim=True).expand_as(s).contiguous()
                for s in (ks, vs)]
    for bad in ((kq, vq, ks, torch.ones_like(vs)), (kq, vq, *per_head)):
        out = DA.decode_attention(qb, knb, vnb, bad, 1, 90).float()
        assert (out - want).abs().max().item() > limit


@pytest.mark.parametrize("T", [1, 3])
def test_cached_attention_int8_matches_jax(T):
    """The port's cached_attention on the int8 layout (decode at T=1, the
    chunked plain arm at T=3) against the JAX package's: the quantized
    payload equal, the output within 2e-5 (fp32)."""
    from paddle_tpu_torch.models import _common as port_common
    q, k, v = _np(2, T, 4, 64), _np(2, T, 2, 64, seed=1), \
        _np(2, T, 2, 64, seed=2)
    _, _, _, cache = _int8_inputs(4, 2, S=100, seed=5)
    got, payload = port_common.cached_attention(
        _t(q), _t(k), _t(v), cache, 61, layer=1)
    want, jpay = jax_common.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        tuple(jnp.asarray(c.numpy()) for c in cache), 61, layer=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(payload) == 4
    for a, b in zip(payload, jpay):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_decode_ignores_positions_past_index():
    q, kn, vn, cache = _decode_inputs(4, 2, S=50)
    kc, vc = (_t(c) for c in cache)
    base = DA.decode_attention(_t(q), _t(kn), _t(vn), (kc, vc), 0, 20)
    kc[:, :, :, 20:] = 1e4
    vc[:, :, :, 20:] = -1e4
    poisoned = DA.decode_attention(_t(q), _t(kn), _t(vn), (kc, vc), 0, 20)
    np.testing.assert_array_equal(base.numpy(), poisoned.numpy())


# ------------------------------------------------------------ dispatch rule

def test_cpu_tensors_take_plain_version_and_do_not_count():
    _support.reset_launches()
    x, w = _t(_np(4, 64)), _t(_np(64, seed=1))
    y = N.rms_norm(x, w)
    assert torch.equal(y, N.rms_norm_reference(x, w))
    assert all(n == 0 for n in _support.LAUNCHES.values())


def test_force_reference_restores_on_exit():
    with _support.force_reference():
        assert _support._force_reference
        with pytest.raises(KeyError):
            with _support.force_reference():
                raise KeyError
        assert _support._force_reference
    assert not _support._force_reference


def test_unsupported_device_raises():
    with pytest.raises(ValueError):
        _support.use_kernel(torch.empty(1, device="meta"))


def test_build_is_content_addressed():
    """The library name hashes the source, the shared header and the
    flags: an edited source can never load a stale build."""
    a = _support._target("rms_norm")
    b = _support._target("rope")
    assert a.parent == _support.BUILD_DIR and a.suffix == ".so"
    assert a.name.startswith("rms_norm-") and a != b
