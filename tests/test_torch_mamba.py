"""The port's Mamba and its selective scan against the JAX package, on the
CPU.

The scan: the port's plain versions (what the kernel wrappers run on CPU
tensors) against the JAX spec ``models/mamba.py:79 selective_scan`` (one
shot and chunked, with the initial and final state), against the Pallas
``_fwd_call`` / ``_bwd_call`` in interpret mode (with two 128-lane
channel blocks, so a dB/dC partial that overwrites another shows), and
against ``jax.vjp`` of the spec; the ``autograd.Function`` passes a
float64 ``gradcheck``. Tolerance 1e-5 abs/rel: the same fp32 recurrence,
sequential here and an associative scan there.

The model: ``MambaConfig.tiny()`` (E=64, Ei=128, N=8, 2 layers, fp32) built
in the JAX package from a key and carried over by ``bridge.py``. Logits
(``__call__`` on the jnp path and under ``force_dispatch``, prefill, the
decode steps) agree within 2e-5 abs/rel, the recurrent state within
1e-5; greedy ``generate`` is token-exact; the loss within rtol 1e-5 and
every gradient within atol 1e-5 / rtol 1e-4 in each head mode with and
without recompute; two ``build_train_step`` steps match the JAX step
(loss, grad_norm, parameters, AdamW moments).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import distributed as jax_dist
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models import generation as jax_generation
from paddle_tpu.models.mamba import MambaConfig as JaxConfig
from paddle_tpu.models.mamba import MambaForCausalLM as JaxMamba
from paddle_tpu.models.mamba import selective_scan as jax_scan
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import _support as jax_support
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.optimizer.transform import AdamState
from paddle_tpu.parallel import mesh as jax_mesh

from chip_smoke import (SCAN_PROBE_LIMIT, bf16_state, bf16_state_scan,
                        bf16_state_scan_bwd)
from paddle_tpu_torch import bridge, optimizer as optim
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.kernels import selective_scan as SS
from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import lr

pytestmark = pytest.mark.port

# the package re-exports the function under the module's name
jax_ss = importlib.import_module("paddle_tpu.ops.pallas.selective_scan")

TOL = dict(rtol=2e-5, atol=2e-5)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
L, V = 2, 256
SCHEDULE = (1e-4, 1, 10)       # warmup_cosine(peak, warmup, total)


def _scan_inputs(nb=2, T=32, Ei=128, N=8, seed=0):
    """(u, delta, A, B, C, D, h0) as numpy fp32, at Mamba's scales."""
    rs = np.random.RandomState(seed)
    f = np.float32
    return (rs.randn(nb, T, Ei).astype(f),
            (np.abs(rs.randn(nb, T, Ei)) * 0.3).astype(f),
            -np.abs(rs.randn(Ei, N)).astype(f) - 0.1,
            rs.randn(nb, T, N).astype(f), rs.randn(nb, T, N).astype(f),
            rs.randn(Ei).astype(f), rs.randn(nb, Ei, N).astype(f))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# ------------------------------------------------------------ the scan

@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_scan_matches_jax_spec(chunk, with_state):
    u, d, A, B, C, D, h0 = _scan_inputs(T=40)
    h0 = h0 if with_state else None
    yj, hj = jax_scan(*map(_j, (u, d, A, B, C, D)), chunk_size=chunk,
                      return_state=True,
                      initial_state=None if h0 is None else _j(h0))
    y, h = SS.selective_scan_reference(*map(_t, (u, d, A, B, C, D)),
                                       None if h0 is None else _t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **SCAN_TOL)
    # the public entry: the same on CPU tensors, y alone without the state
    y2 = SS.selective_scan(*map(_t, (u, d, A, B, C, D)),
                           initial_state=None if h0 is None else _t(h0))
    assert torch.equal(y2, y)


def test_plain_scan_matches_pallas_forward():
    """y and the chunk-boundary states of the Pallas forward (two channel
    blocks of 128 lanes, 4 chunks of 8) against the plain version run
    chunk by chunk."""
    u, d, A, B, C, D, _ = _scan_inputs(T=32, Ei=256, seed=1)
    with jax_support.force_dispatch():
        yj, hsj = jax_ss._fwd_call(*map(_j, (u, d, A.T, B, C, D[None])), 8)
    y, _ = SS.selective_scan_reference(*map(_t, (u, d, A, B, C, D)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SCAN_TOL)
    h = None
    for c in range(4):
        want = np.asarray(hsj)[:, c].transpose(0, 2, 1)     # [B, Ei, N]
        got = np.zeros_like(want) if h is None else h.numpy()
        np.testing.assert_allclose(got, want, **SCAN_TOL, err_msg=f"{c}")
        sl = slice(8 * c, 8 * c + 8)
        _, h = SS.selective_scan_reference(
            *(_t(a[:, sl]) for a in (u, d)), _t(A),
            *(_t(a[:, sl]) for a in (B, C)), _t(D), h)


def test_plain_bwd_matches_pallas_backward():
    """du, dΔ, dB, dC and the per-batch dA partials of the Pallas backward
    (two channel blocks: its dB/dC are per-block partials summed outside)
    against the plain backward."""
    u, d, A, B, C, D, _ = _scan_inputs(T=32, Ei=256, seed=2)
    dy = np.random.RandomState(3).randn(*u.shape).astype(np.float32)
    with jax_support.force_dispatch():
        args = tuple(map(_j, (u, d, A.T, B, C)))
        _, hsj = jax_ss._fwd_call(*args, _j(D[None]), 8)
        want = jax_ss._bwd_call(*args, hsj, _j(dy), 8)
    du, ddt, dA_part, dB, dC, _ = SS.selective_scan_bwd_reference(
        *map(_t, (u, d, A, B, C, dy)))
    got = (du, ddt, dB, dC, dA_part.transpose(1, 2))
    for name, a, b in zip(("du", "ddelta", "dB", "dC", "dA"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-5, err_msg=name)


def test_plain_bwd_matches_jax_vjp():
    """The explicit reverse adjoint against ``jax.vjp`` of the spec, with
    an initial state and a gradient on the final state; the D·u terms and
    the batch sum of dA added as the autograd wiring adds them."""
    u, d, A, B, C, D, h0 = _scan_inputs(T=37, Ei=96, seed=4)
    rs = np.random.RandomState(5)
    dy = rs.randn(*u.shape).astype(np.float32)
    dh = rs.randn(*h0.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_scan(*a[:6], return_state=True,
                                         initial_state=a[6]),
                     *map(_j, (u, d, A, B, C, D, h0)))
    want = vjp((_j(dy), _j(dh)))
    du, ddt, dA_part, dB, dC, dh0 = SS.selective_scan_bwd_reference(
        *map(_t, (u, d, A, B, C, dy, h0, dh)))
    got = (du + _t(dy) * _t(D), ddt, dA_part.sum(0), dB, dC,
           (_t(dy) * _t(u)).sum((0, 1)), dh0)
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dh0"),
                          got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_scan_function_gradcheck():
    """The ``autograd.Function`` in float64 (its plain branch) against
    finite differences, every input the initial state included, through
    y and the final state."""
    rs = np.random.RandomState(6)
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in (rs.randn(1, 5, 3), np.abs(rs.randn(1, 5, 3)) * 0.5,
                      -np.abs(rs.randn(3, 2)) - 0.2, rs.randn(1, 5, 2),
                      rs.randn(1, 5, 2), rs.randn(3), rs.randn(1, 3, 2))]

    def fn(u, d, A, B, C, D, h0):
        return SS.selective_scan(u, d, A, B, C, D, initial_state=h0,
                                 return_state=True)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
def test_bf16_state_control(with_h0):
    """``chip_smoke.py``'s scan control: the plain versions with the state
    and the adjoint rounded to bf16 after every step (over two of their
    64-step chunks). Every output lies above the probe's limit from the
    plain versions, so the probe can tell it apart, and within 2e-2
    relative L2 of them (a few bf16 roundings of 2^-9 each: they read
    3.7e-3-7.3e-3; a control that dropped a term would read O(1)). Under ``bf16_state()`` the ``autograd.Function``
    runs it, forward and backward."""
    u, d, A, B, C, D, h0 = map(_t, _scan_inputs(T=100, Ei=64, seed=8))
    h0 = h0 if with_h0 else None
    dy = _t(np.random.RandomState(9).randn(*u.shape).astype(np.float32))
    want = (*SS.selective_scan_reference(u, d, A, B, C, D, h0),
            *SS.selective_scan_bwd_reference(u, d, A, B, C, dy, h0)[:5])
    ctrl = (*bf16_state_scan(u, d, A, B, C, D, h0),
            *bf16_state_scan_bwd(u, d, A, B, C, dy, h0)[:5])
    for name, c, w in zip(("y", "h_T", "du", "ddelta", "dA", "dB", "dC"),
                          ctrl, want):
        rel = ((c - w).norm() / w.norm()).item()
        assert SCAN_PROBE_LIMIT < rel < 2e-2, (name, rel)
    leaves = [x.clone().requires_grad_() for x in (u, d)]
    with bf16_state():
        y, h = SS.selective_scan(*leaves, A, B, C, D, initial_state=h0,
                                 return_state=True)
        du, dd = torch.autograd.grad((y * dy).sum(), leaves)
    torch.testing.assert_close(y, ctrl[0], rtol=0, atol=0)
    torch.testing.assert_close(h, ctrl[1], rtol=0, atol=0)
    torch.testing.assert_close(du, ctrl[2] + dy * D, rtol=0, atol=0)
    torch.testing.assert_close(dd, ctrl[3], rtol=0, atol=0)


def test_scan_kernel_takes_float32_only(monkeypatch):
    """Where the kernel would launch, another type raises (the kernel is
    fp32 only, as the Pallas one) before anything is built."""
    monkeypatch.setattr(_support, "use_kernel", lambda x: True)
    u, d, A, B, C, D, _ = (_t(a).bfloat16() for a in _scan_inputs(T=4))
    with pytest.raises(TypeError, match="float32"):
        SS.selective_scan(u, d, A, B, C, D)


@pytest.mark.parametrize("beta,threshold", [(1.0, 20.0), (2.0, 5.0)])
def test_softplus_matches_jax(beta, threshold):
    x = np.random.RandomState(7).randn(300).astype(np.float32) * 8
    want = np.asarray(JF.softplus(_j(x), beta, threshold))
    got = TF.softplus(_t(x), beta, threshold).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the model

def _pair(**cfg):
    jm = JaxMamba(dataclasses.replace(JaxConfig.tiny(), **cfg),
                  key=jax.random.PRNGKey(7))
    tm = MambaForCausalLM(dataclasses.replace(MambaConfig.tiny(), **cfg),
                          device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _ids(B=2, T=12, seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(
        np.int32)


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_config_and_parameter_count_match_jax():
    for kw in ({}, dict(vocab_size=50304, hidden_size=1024,
                        dtype="bfloat16", remat=True)):
        mine, ref = MambaConfig(**kw), JaxConfig(**kw)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert (mine.inner_size, mine.rank, mine.num_params()) == (
            ref.inner_size, ref.rank, ref.num_params())
    assert MambaConfig.tiny() == MambaConfig(**dataclasses.asdict(
        JaxConfig.tiny()))
    tm = MambaForCausalLM(MambaConfig.tiny(), device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == \
        MambaConfig.tiny().num_params()


def test_state_dict_names_and_shapes_match_jax(pair):
    jm, tm = pair
    jsd = state_dict(jm)
    assert sorted(jsd) == sorted(
        ["embed.weight", "norm.weight"] + [f"blocks.block.{n}" for n in (
            "A_log", "D", "conv_weight", "conv_bias", "in_proj.weight",
            "x_proj.weight", "dt_proj.weight", "dt_proj.bias",
            "out_proj.weight", "norm.weight")])
    want = bridge.from_jax_state_dict(jsd, L)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name


def test_bf16_model_keeps_A_log_and_D_fp32():
    tm = MambaForCausalLM(MambaConfig.tiny(dtype="bfloat16"), device="cpu")
    types = {n.split(".")[-1]: p.dtype for n, p in tm.named_parameters()}
    assert types["A_log"] == types["D"] == torch.float32
    assert types["conv_weight"] == types["weight"] == torch.bfloat16
    jm = JaxMamba(JaxConfig.tiny(dtype="bfloat16"), key=jax.random.PRNGKey(0))
    for name, arr in bridge.from_jax_state_dict(state_dict(jm), L).items():
        assert str(tm.state_dict()[name].dtype)[6:] == str(arr.dtype), name


@pytest.mark.parametrize("dispatch", ["jnp", "pallas"])
def test_call_logits_match(pair, dispatch):
    """The JAX forward on its jnp spec and through the Pallas kernel
    (interpret mode, T=16 passes its gate)."""
    jm, tm = pair
    ids = _ids(T=16)
    if dispatch == "pallas":
        with jax_support.force_dispatch():
            want = np.asarray(jm(jnp.asarray(ids)))
    else:
        want = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(_long(ids)).numpy()
    assert got.shape == (2, 16, V)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_and_steps_match_jax(pair):
    """Prefill (the scan with the carried state) and three decode steps:
    logits and both cache leaves against the JAX package's."""
    jm, tm = pair
    ids = _ids(T=10, seed=1)
    jl, jc = jm.forward_with_cache(jnp.asarray(ids), jm.init_cache(2))
    tl, tc = tm.forward_with_cache(_long(ids), tm.init_cache(2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SCAN_TOL)
    for step in range(3):
        tok = ids[:, step:step + 1]
        jl, jc = jm.forward_with_cache(jnp.asarray(tok), jc)
        tl, tc = tm.forward_with_cache(_long(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SCAN_TOL)


def test_stateful_decode_matches_the_sequence_forward(pair):
    """As ``tests/test_selective_scan.py:152-183``: prefill logits, the
    teacher-forced steps' logits and the prefill → step state handoff all
    equal the whole-sequence forward."""
    _, tm = pair
    ids = _long(_ids(T=12, seed=2))
    with torch.no_grad():
        full = tm(ids)
    pre, cache_p = tm.forward_with_cache(ids, tm.init_cache(2))
    torch.testing.assert_close(pre, full, **TOL)
    cache = tm.init_cache(2)
    steps = []
    for t in range(ids.shape[1]):
        lg, cache = tm.forward_with_cache(ids[:, t:t + 1], cache)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=2e-4,
                               atol=2e-5)
    for a, b in zip(cache_p, cache):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def test_chunked_prefill_continues_exactly(pair):
    """Prefill of 7 then 9 tokens equals one 16-token prefill: logits and
    carried state (the scan seeded with the state the first part
    returned)."""
    _, tm = pair
    ids = _long(_ids(T=16, seed=3))
    one_lg, one_cache = tm.forward_with_cache(ids, tm.init_cache(2))
    lg_a, cache = tm.forward_with_cache(ids[:, :7], tm.init_cache(2))
    lg_b, cache = tm.forward_with_cache(ids[:, 7:], cache)
    torch.testing.assert_close(torch.cat([lg_a, lg_b], 1), one_lg, **TOL)
    for a, b in zip(cache, one_cache):
        torch.testing.assert_close(a, b, **SCAN_TOL)


def test_short_prompt_pads_the_conv_tail():
    """A 2-token prompt (< K - 1) prefills with zero padding; the steps
    after it match the JAX package's and the whole forward."""
    jm, tm = _pair(conv_kernel=4)
    ids = _ids(B=1, T=5, seed=4)
    _, jc = jm.forward_with_cache(jnp.asarray(ids[:, :2]), jm.init_cache(1))
    _, tc = tm.forward_with_cache(_long(ids[:, :2]), tm.init_cache(1))
    outs = []
    for t in range(2, 5):
        jl, jc = jm.forward_with_cache(jnp.asarray(ids[:, t:t + 1]), jc)
        tl, tc = tm.forward_with_cache(_long(ids[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        outs.append(tl[:, 0])
    with torch.no_grad():
        full = tm(_long(ids))
    torch.testing.assert_close(torch.stack(outs, 1), full[:, 2:], rtol=2e-4,
                               atol=2e-5)


def test_conv_kernel_one_carries_an_empty_tail():
    jm, tm = _pair(conv_kernel=1)
    ids = _ids(T=6, seed=5)
    _, tc = tm.forward_with_cache(_long(ids[:, :4]), tm.init_cache(2))
    assert tc[0].shape == (L, 2, 0, 128)
    outs = []
    for t in range(4, 6):
        lg, tc = tm.forward_with_cache(_long(ids[:, t:t + 1]), tc)
        outs.append(lg[:, 0].numpy())
    want = np.asarray(jm(jnp.asarray(ids)))[:, 4:]
    np.testing.assert_allclose(np.stack(outs, 1), want, rtol=2e-4,
                               atol=2e-5)


def test_greedy_generate_token_exact(pair):
    jm, tm = pair
    ids = _ids(seed=6)
    want = np.asarray(jax_generation.generate(jm, jnp.asarray(ids), 9))
    got = tm.generate(_long(ids), 9).numpy()
    np.testing.assert_array_equal(got, want)
    # the int8 cache request maps back to the float state, as in JAX
    got8 = tm.generate(_long(ids), 9, cache_dtype=torch.int8).numpy()
    np.testing.assert_array_equal(got8, want)


def test_init_cache_dtypes(pair):
    jm, tm = pair
    for dtype, jdtype in ((None, None), (torch.int8, jnp.int8),
                          (torch.bfloat16, jnp.bfloat16)):
        got, want = tm.init_cache(3, None, dtype), jm.init_cache(3, None,
                                                                jdtype)
        for a, b in zip(got, want):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype)[6:] == str(b.dtype)
    with pytest.raises(ValueError, match="unsupported"):
        tm.init_cache(1, dtype=torch.int32)


def _batch(seed=0, T=32):
    ids = _ids(T=T, seed=seed)
    labels = ids.copy()
    labels[0, 3:7] = -100
    return ids, labels


@pytest.mark.parametrize("mode", ["dense", "fused", "chunked", "auto"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(mode, remat):
    """Each head mode (the JAX fused mode runs its chunked arm on the CPU,
    auto its dense one), with and without per-block recompute."""
    jm, tm = _pair(lm_head_mode=mode, remat=remat)
    ids, labels = _batch(8)
    want, jgrads = jax.value_and_grad(
        lambda m: m.loss(jnp.asarray(ids), jnp.asarray(labels)))(jm)
    loss = tm.loss(_long(ids), _long(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = bridge.from_jax_state_dict(state_dict(jgrads), L)
    got_g = bridge.grads_state_dict(tm)
    assert sorted(got_g) == sorted(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], **GRAD_TOL,
                                   err_msg=name)


def _adam_numpy(opt_state):
    adam = next(s for s in opt_state if isinstance(s, AdamState))
    return (int(adam.count),
            {k: np.array(v) for k, v in state_dict(adam.mu).items()},
            {k: np.array(v) for k, v in state_dict(adam.nu).items()})


def test_two_train_steps_match_jax():
    """Two ``build_train_step`` steps (AdamW on ``warmup_cosine``, global
    norm clip at 1.0) from the same weights, with recompute: loss,
    grad_norm and every parameter after each step, and the AdamW moments
    at the end."""
    jm, tm = _pair(remat=True)
    ids, labels = _batch(9)
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
        state, metrics = step(state, {"input_ids": _long(ids),
                                      "labels": _long(labels)})
        np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm,
                                   rtol=1e-5)
        # AdamW's normalised step moves an element by up to lr (1e-4)
        # whatever its gradient's size, so where a gradient sits near zero
        # its step turns on fp32 rounding in the recurrence (one element in
        # 16384 lands 3.6e-6 apart): parameters are held at a tenth of a
        # step, the gradients themselves in the test above
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), params[name],
                                       atol=1e-5, rtol=0,
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
    """JAX state dict → port → JAX is the identity (the fp32 A_log and D
    included), the loaded model restacks to the JAX arrays, and AdamW
    moments cross both ways."""
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
    rs = np.random.RandomState(10)
    mu = {k: rs.randn(*v.shape).astype(np.float32) for k, v in sd.items()}
    nu = {k: rs.rand(*v.shape).astype(np.float32) for k, v in sd.items()}
    port = bridge.adamw_state_from_jax(3, mu, nu, tm)
    assert port.mu["blocks.1.A_log"].shape == (128, 8)
    count, mu2, nu2 = bridge.adamw_state_to_jax(port, L)
    assert count == 3
    for a, b in ((mu, mu2), (nu, nu2)):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])


def test_mixed_type_adamw_step_updates_fp32_and_bf16_parameters():
    """A bf16 model's step updates its fp32 (A_log, D) and bf16 parameters
    in one optimizer step, each in its own type."""
    tm = MambaForCausalLM(MambaConfig.tiny(dtype="bfloat16"), device="cpu")
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step = fleet.build_train_step(tm, optim.AdamW(1e-2))
    ids, labels = _batch(11)
    state, metrics = step(step.init_state(tm), {"input_ids": _long(ids),
                                                "labels": _long(labels)})
    assert np.isfinite(metrics["loss"].item())
    for name, p in tm.named_parameters():
        assert p.dtype == before[name].dtype
        if name.endswith(("A_log", "D", "in_proj.weight")):
            assert not torch.equal(p, before[name]), name
