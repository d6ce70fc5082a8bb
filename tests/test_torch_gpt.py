"""The port's GPT-3 family against the JAX package, on the CPU.

``GPTConfig.tiny()`` (hidden 64, 4 heads, 2 layers, fp32) is built in the
JAX package from a key and carried into the port by ``bridge.py``. Logits
(``__call__``, prefill, decode) agree within 2e-5 abs/rel: the same fp32
arithmetic in another summation order (the JAX LayerNorm runs its plain
arm, the port's the plain version of the layer_norm kernel). Greedy
``generate`` is token-exact. Loss within rtol 1e-5 and every gradient
within atol 1e-5 / rtol 1e-4 under each head mode, with and without
recompute; two ``build_train_step`` steps against the JAX step (loss,
grad_norm, every parameter, the AdamW moments). The weight bridge
round-trips GPT's biased state dict and its moments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import distributed as jax_dist
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models import generation as jax_generation
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.optimizer.transform import AdamState
from paddle_tpu.parallel import mesh as jax_mesh

from paddle_tpu_torch import bridge, optimizer as optim
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import lr

pytestmark = pytest.mark.port

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
L, V = 2, 256
SCHEDULE = (1e-4, 1, 10)       # warmup_cosine(peak, warmup, total)


def _pair(**cfg):
    jm = JaxGPT(dataclasses.replace(JaxConfig.tiny(), **cfg),
                key=jax.random.PRNGKey(5))
    tm = GPTForCausalLM(dataclasses.replace(GPTConfig.tiny(), **cfg),
                        device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _ids(B=2, T=12, seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_config_and_parameter_count_match_jax():
    for name in ("gpt3_6_7b", "gpt3_1_3b", "tiny"):
        mine, ref = getattr(GPTConfig, name)(), getattr(JaxConfig, name)()
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), name
        assert mine.num_params() == ref.num_params()
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == \
        GPTConfig.tiny().num_params()


def test_state_dict_names_and_shapes_match_jax(pair):
    jm, tm = pair
    want = bridge.from_jax_state_dict(state_dict(jm), L)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
    assert "blocks.1.wqkv.bias" in got and "lm_head.bias" not in got


def test_call_logits_match(pair):
    jm, tm = pair
    ids = _ids()
    want = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(_t(ids)).numpy()
    assert got.shape == (2, 12, V)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_and_decode_logits_match(pair):
    jm, tm = pair
    ids = _ids(T=10, seed=1)
    jc = jm.init_cache(2, 16)
    tc = tm.init_cache(2, 16)
    jl, jc = jm.forward_with_cache(jnp.asarray(ids), jc, 0)
    tl, tc = tm.forward_with_cache(_t(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for step in range(3):
        tok = ids[:, step:step + 1]
        jl, jc = jm.forward_with_cache(jnp.asarray(tok), jc, 10 + step)
        tl, tc = tm.forward_with_cache(_t(tok), tc, 10 + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")


def test_greedy_generate_token_exact(pair):
    jm, tm = pair
    ids = _ids(seed=2)
    want = np.asarray(jax_generation.generate(jm, jnp.asarray(ids), 9))
    got = tm.generate(_t(ids), 9).numpy()
    np.testing.assert_array_equal(got, want)


def test_init_cache_raises_past_max_seq_len(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.init_cache(1, tm.config.max_seq_len + 1)
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.generate(_t(_ids(T=120)), 9)


def _batch(seed=0, T=32):
    ids = _ids(T=T, seed=seed)
    labels = ids.copy()
    labels[0, 3:7] = -100
    return ids, labels


def _loss_and_grads_match_jax(jm, tm, seed=0):
    ids, labels = _batch(seed)
    want, jgrads = jax.value_and_grad(
        lambda m: m.loss(jnp.asarray(ids), jnp.asarray(labels)))(jm)
    loss = tm.loss(_t(ids), _t(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = bridge.from_jax_state_dict(state_dict(jgrads), L)
    got_g = bridge.grads_state_dict(tm)
    assert sorted(got_g) == sorted(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["dense", "fused", "chunked", "auto"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(mode, remat):
    """Each head mode (the JAX fused mode runs its chunked arm on the CPU,
    auto its dense one), with and without per-block recompute."""
    _loss_and_grads_match_jax(*_pair(lm_head_mode=mode, remat=remat))


def test_dropout_draws_from_the_callers_generator():
    """With dropout the loss depends on the generator's seed only: the
    same seed gives the same loss, another seed another one, and eval
    ignores it."""
    _, tm = _pair(dropout=0.2)
    ids, labels = (_t(a) for a in _batch(3))

    def loss(seed):
        return tm.loss(ids, labels, generator=torch.Generator().manual_seed(
            seed)).item()
    assert loss(1) == loss(1) and loss(1) != loss(2)
    with pytest.raises(ValueError, match="Generator"):
        tm.loss(ids, labels)
    assert tm.loss(ids, labels, training=False).item() == \
        tm.loss(ids, labels, training=False,
                generator=torch.Generator().manual_seed(9)).item()


def _adam_numpy(opt_state):
    adam = next(s for s in opt_state if isinstance(s, AdamState))
    return (int(adam.count),
            {k: np.array(v) for k, v in state_dict(adam.mu).items()},
            {k: np.array(v) for k, v in state_dict(adam.nu).items()})


def test_two_train_steps_match_jax():
    """Two ``build_train_step`` steps (AdamW on ``warmup_cosine``, global
    norm clip at 1.0) from the same weights: loss, grad_norm and every
    parameter after each step, and the AdamW moments at the end."""
    jm, tm = _pair()
    ids, labels = _batch(4)
    mesh = jax_mesh.create_mesh({"dp": 1}, devices=jax.devices()[:1])
    with jax_mesh.MeshContext(mesh):
        jstep = jax_dist.fleet.build_train_step(
            jm, optimizer=jax_optim.AdamW(
                jax_lr.warmup_cosine(*SCHEDULE),
                grad_clip=jax_optim.ClipGradByGlobalNorm(1.0)), mesh=mesh)
        jstate = jstep.init_state(jm)
        data = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}
        want = []
        for i in range(2):
            jstate, metrics = jstep(jstate, data, jax.random.PRNGKey(i))
            want.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                         bridge.from_jax_state_dict(state_dict(jstate.model),
                                                    L),
                         _adam_numpy(jstate.opt_state)))
    step = fleet.build_train_step(tm, optim.AdamW(
        lr.warmup_cosine(*SCHEDULE),
        grad_clip=optim.ClipGradByGlobalNorm(1.0)))
    state = step.init_state(tm)
    _support.reset_launches()
    for i, (loss, gnorm, params, _) in enumerate(want):
        state, metrics = step(state, {"input_ids": _t(ids),
                                      "labels": _t(labels)})
        np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm,
                                   rtol=1e-5)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), params[name],
                                       atol=1e-6, rtol=0,
                                       err_msg=f"step {i} {name}")
    assert all(n == 0 for n in _support.LAUNCHES.values())
    count, mu, nu = bridge.adamw_state_to_jax(state.opt_state, L)
    adam = want[-1][3]
    assert count == adam[0]
    for got, ref, atol in ((mu, adam[1], 1e-6), (nu, adam[2], 1e-10)):
        assert sorted(got) == sorted(ref)
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], atol=atol,
                                       rtol=1e-4, err_msg=name)


def test_bridge_round_trips_weights_and_moments(pair):
    """JAX state dict → port → JAX is the identity, the loaded model's
    parameters restack to the JAX arrays, and AdamW moments cross both
    ways; a name left over on either side raises."""
    jm, tm = pair
    sd = {k: np.asarray(v) for k, v in state_dict(jm).items()}
    back = bridge.to_jax_state_dict(bridge.from_jax_state_dict(sd, L), L)
    assert sorted(back) == sorted(sd)
    for name in sd:
        np.testing.assert_array_equal(back[name], sd[name])
    restacked = bridge.to_jax_state_dict(
        {n: p.detach().numpy() for n, p in tm.named_parameters()}, L)
    for name in sd:
        np.testing.assert_array_equal(restacked[name], sd[name])
    rs = np.random.RandomState(6)
    mu = {k: rs.randn(*v.shape).astype(np.float32) for k, v in sd.items()}
    nu = {k: rs.rand(*v.shape).astype(np.float32) for k, v in sd.items()}
    port = bridge.adamw_state_from_jax(3, mu, nu, tm)
    assert port.mu["blocks.0.wqkv.bias"].shape == (3 * 64,)
    count, mu2, nu2 = bridge.adamw_state_to_jax(port, L)
    assert count == 3
    for a, b in ((mu, mu2), (nu, nu2)):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    extra = dict(sd, **{"blocks.block.extra.weight": sd[
        "blocks.block.wo.weight"]})
    with pytest.raises(KeyError, match="unexpected"):
        bridge.load_jax_state_dict(tm, extra)
    short = {k: v for k, v in sd.items() if k != "ln_f.bias"}
    with pytest.raises(KeyError, match="missing"):
        bridge.load_jax_state_dict(tm, short)
    with pytest.raises(KeyError, match="moments"):
        bridge.adamw_state_from_jax(3, {k: mu[k] for k in short}, nu, tm)
