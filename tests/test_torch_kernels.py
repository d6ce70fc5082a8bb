"""The port's four kernel modules against the JAX package, in fp32 on the CPU.

For each kernel the port's plain version (what its wrapper runs on a CPU
tensor) is held against the Pallas kernel, run in interpret mode under
``force_dispatch`` as ``tests/test_decode_attention.py`` runs it, at shapes
its gates accept (D=64, T=128, S=128), and against the JAX package's plain
arm. Tolerance 2e-5 abs/rel: both sides compute in fp32, in another
summation order. Inputs come from a numpy seed and go to both sides.

The CUDA kernels themselves run only on the card: ``test_kernel_on_card``
holds each against its plain version there and skips without a GPU.
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
from paddle_tpu.ops.pallas import decode_attention as jax_decode
from paddle_tpu.ops.pallas import norm as jax_norm
from paddle_tpu.ops.pallas import rope as jax_rope

from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.kernels import decode_attention as DA
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import norm as N
from paddle_tpu_torch.kernels import rope as R
from paddle_tpu_torch.nn import functional as TF

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
    """A multi-token chunk at index > 0 has no kernel yet: where the
    wrappers would launch kernels it raises instead of running the plain
    version on the card."""
    from paddle_tpu_torch.models import _common as port_common
    monkeypatch.setattr(_support, "use_kernel", lambda x: True)
    q, k = _t(_np(1, 3, 2, 64)), _t(_np(1, 3, 2, 64, seed=1))
    cache = (_t(_np(1, 1, 2, 16, 64, seed=2)),) * 2
    with pytest.raises(NotImplementedError):
        port_common.cached_attention(q, k, k, cache, 5, layer=0)


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


@pytest.mark.parametrize("name", _support.KERNELS)
def test_kernel_on_card(name):
    """Each CUDA kernel against its plain version on the card, bf16.
    Tolerance 2e-2 abs + rel: bf16 output rounding (2^-8 relative) plus
    another fp32 summation order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100; the CPU run "
                    "covers the plain versions)")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)

    if name == "rms_norm":
        x, w = rn(5, 4096), rn(4096)
        got, want = N.rms_norm(x, w, 1e-5), N.rms_norm_reference(x, w, 1e-5)
    elif name == "rope":
        x = rn(2, 3, 8, 128)
        cos = torch.rand(3, 64, generator=g, device="cuda")
        sin = torch.rand(3, 64, generator=g, device="cuda")
        got = R.apply_rotary(x, cos, sin)
        want = R.apply_rotary_reference(x, cos, sin)
    elif name == "flash_attention":
        q, k, v = rn(2, 77, 8, 128), rn(2, 77, 2, 128), rn(2, 77, 2, 128)
        got = FA.flash_attention(q, k, v, causal=True)
        want = FA.flash_attention_reference(q, k, v, causal=True)
    else:
        q, kn, vn = rn(2, 1, 8, 128), rn(2, 2, 1, 128), rn(2, 2, 1, 128)
        cache = (rn(3, 2, 2, 90, 128), rn(3, 2, 2, 90, 128))
        got = DA.decode_attention(q, kn, vn, cache, 2, 41)
        want = DA.decode_attention_reference(q, kn, vn, cache, 2, 41)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
