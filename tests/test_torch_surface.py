"""Arguments the JAX package's functions take and the port's lacked
(ROADMAP Queue C item 1), each against the JAX function on the CPU:
``scaled_dot_product_attention(dropout_p=, training=, use_pallas=)``,
``layer_norm(axis=)``, ``rotary_embedding(dtype=)`` and ``training=`` on
Llama's and Mamba's ``hidden_states`` and ``loss``. (Soft labels and
class weights of the losses are in ``tests/test_torch_softmax_xent.py``.)
fp32 within 2e-5 abs/rel: the same arithmetic in another order.

Dropout draws from the caller's ``torch.Generator`` in the port and from
a threefry key in the JAX package, so the two cannot draw the same mask:
the port's dropped-out attention is held against the JAX einsum arm's
formula (``nn/functional.py:589-611``) with the port's own keep-mask
replayed, and its training=False and dropout_p=0 forms against the JAX
function itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.mamba import MambaConfig as JaxMambaConfig
from paddle_tpu.models.mamba import MambaForCausalLM as JaxMamba
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import bridge
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     MambaConfig, MambaForCausalLM)
from paddle_tpu_torch.nn import functional as TF

pytestmark = pytest.mark.port

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed=0, B=2, T=6, Hq=4, Hkv=2, D=16):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, T, h, D).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))


# --------------------------------------------- scaled_dot_product_attention

@pytest.mark.parametrize("use_pallas", ["never", False, "auto", True])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_use_pallas_matches_jax(use_pallas, causal):
    """``use_pallas="never"`` (or False) takes the einsum arm, the others
    the flash kernel's path (its plain version on the CPU): both equal
    the JAX function."""
    q, k, v = _qkv()
    jmode = {False: "never", True: "auto"}.get(use_pallas, use_pallas)
    want = JF.scaled_dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, use_pallas=jmode)
    got = TF.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sdpa_rejects_an_unknown_use_pallas():
    q, k, v = map(torch.from_numpy, _qkv())
    with pytest.raises(ValueError, match="use_pallas"):
        TF.scaled_dot_product_attention(q, k, v, use_pallas="sometimes")


@pytest.mark.parametrize("training", [False, True])
def test_sdpa_dropout_off_matches_jax(training):
    """dropout_p > 0 without training, and dropout_p = 0 in training, drop
    nothing: the JAX function's output (its einsum arm where dropout_p >
    0, as the JAX package routes it)."""
    q, k, v = _qkv(1)
    p = 0.0 if training else 0.3
    want = JF.scaled_dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, dropout_p=p,
        training=training)
    got = TF.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), causal=True, dropout_p=p,
        training=training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sdpa_dropout_in_training_is_the_jax_arm_with_the_same_mask():
    q, k, v = _qkv(2)
    p = 0.25
    got = TF.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), causal=True, dropout_p=p,
        training=True, generator=torch.Generator().manual_seed(11))
    # the keep-mask the port drew: u < 1 - p over the [B, H, Tq, Tk] probs
    u = torch.rand((2, 4, 6, 6), generator=torch.Generator().manual_seed(11))
    keep = jnp.asarray((u < 1 - p).numpy())
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jk, jv = jnp.repeat(jk, 2, axis=2), jnp.repeat(jv, 2, axis=2)
    logits = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) / 4.0
    causal = jnp.tril(jnp.ones((6, 6), bool))
    logits = jnp.where(causal, logits, jnp.finfo(logits.dtype).min)
    probs = jax.nn.softmax(logits, axis=-1)
    probs = jnp.where(keep, probs / (1 - p), 0.0)
    want = jnp.einsum("bhqk,bkhd->bqhd", probs, jv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="Generator"):
        TF.scaled_dot_product_attention(
            *map(torch.from_numpy, (q, k, v)), dropout_p=p, training=True)


# ------------------------------------------------------ layer_norm(axis)

# the affine parameters' shape for each axis of a [3, 5, 8] input
LN_PARAM_SHAPES = {-1: (8,), 2: (8,), 1: (5, 1), (1, 2): (5, 8),
                   0: (3, 1, 1)}


@pytest.mark.parametrize("axis", list(LN_PARAM_SHAPES), ids=str)
@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm_axis_matches_jax(axis, affine):
    rs = np.random.RandomState(3)
    x = (rs.randn(3, 5, 8) * 2 + 1).astype(np.float32)
    shape = LN_PARAM_SHAPES[axis]
    w = (rs.rand(*shape) + 0.5).astype(np.float32) if affine else None
    b = rs.randn(*shape).astype(np.float32) if affine else None

    def opt(a, lib):
        return None if a is None else lib(a)
    want = JF.layer_norm(jnp.asarray(x), opt(w, jnp.asarray),
                         opt(b, jnp.asarray), 1e-5, axis=axis)
    got = TF.layer_norm(torch.from_numpy(x), opt(w, torch.from_numpy),
                        opt(b, torch.from_numpy), 1e-5, axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------ rotary_embedding(dtype)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_embedding_dtype_matches_jax(dtype):
    pos = np.arange(0, 300, 7)
    jc, js = JF.rotary_embedding(jnp.asarray(pos), 32,
                                 dtype=getattr(jnp, dtype))
    tc, ts = TF.rotary_embedding(torch.from_numpy(pos), 32,
                                 dtype=getattr(torch, dtype))
    assert tc.dtype == getattr(torch, dtype)
    for a, b in ((tc, jc), (ts, js)):
        # fp32 tables within 2e-5; bf16 tables are the same fp32 values
        # rounded once (the JAX package's cos of a large angle may differ
        # in the last fp32 bits, which a bf16 rounding can flip)
        tol = TOL if dtype == "float32" else dict(rtol=2.0 ** -8,
                                                  atol=2.0 ** -9)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)), **tol)


# ---------------------------------------- training= on Llama and Mamba

def _llama():
    jm = JaxLlama(JaxLlamaConfig.tiny(), key=jax.random.PRNGKey(4))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


def _mamba():
    jm = JaxMamba(JaxMambaConfig.tiny(), key=jax.random.PRNGKey(4))
    tm = MambaForCausalLM(MambaConfig.tiny(), device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


@pytest.mark.parametrize("family", [_llama, _mamba],
                         ids=["llama", "mamba"])
@pytest.mark.parametrize("training", [False, True])
def test_hidden_states_and_loss_take_training(family, training):
    """``hidden_states(training=)``, ``forward(training=)`` and
    ``loss(training=)`` as in the JAX models (neither family has
    dropout: the flag changes nothing, on either side)."""
    jm, tm = family()
    ids = np.random.RandomState(5).randint(0, 256, (2, 16)).astype(np.int32)
    tids = torch.from_numpy(ids).long()
    want_h = jm.hidden_states(jnp.asarray(ids), training=training)
    want_loss = jm.loss(jnp.asarray(ids), jnp.asarray(ids),
                        training=training)
    with torch.no_grad():
        got_h = tm.hidden_states(tids, training=training)
        got_logits = tm(tids, training=training)
        got_loss = tm.loss(tids, tids, training=training)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(
        got_logits.numpy(),
        np.asarray(jm(jnp.asarray(ids), training=training)), **TOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
