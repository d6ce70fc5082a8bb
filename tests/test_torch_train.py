"""The port's training slice against the JAX package's jnp path, on the CPU.

The JAX model is built from a key (``LlamaConfig.tiny()``: hidden 64,
4 heads over 2 kv heads, 2 layers, fp32) and carried into the port by
``bridge.py``; both see the same numpy batch (B=2, T=128, a few labels
at ``ignore_index``). On the CPU every kernel wrapper runs its plain
version, and the JAX package runs its jnp arms, so the two compute the
same fp32 arithmetic in another summation order:
- loss: rtol 1e-5;
- gradients, parameter by parameter: atol 1e-5, rtol 1e-4;
- three ``build_train_step`` steps with AdamW on ``warmup_cosine`` and
  ``ClipGradByGlobalNorm``: loss and grad_norm rtol 1e-5, every parameter
  after each step atol 1e-6, the AdamW moments rtol 1e-4 (the gradients'
  rtol) over atol 1e-6 (first) and 1e-10 (second, ~g²/1000).
  The peak learning rate is 1e-4, so a step moves a weight by up to
  ~1e-4 and the 1e-6 limit is 1% of a step. Adam's step g/(|g| + eps)
  turns fp32 summation noise in a gradient near eps=1e-8 into a visible
  change of that weight's step: at a peak of 1e-3 one weight of 10752
  (``blocks.0.mlp.gate``) landed 2.1e-6 from the JAX package's.
The same loss and gradient tolerances hold for every head mode (tied and
untied) and every recompute policy; the steps run with the default
config and with ``bench.py``'s (fused head, ``save_mlp_dots_attn``).
Gradients under a policy against the port without recompute: rtol 1e-6,
atol 1e-7 (the same ops, recomputed).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import distributed as jax_dist
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.optimizer.transform import AdamState
from paddle_tpu.parallel import mesh as jax_mesh

from paddle_tpu_torch import bridge, optimizer as optim
from paddle_tpu_torch.distributed import DistributedStrategy, fleet
from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import scan
from paddle_tpu_torch.optimizer import lr

pytestmark = pytest.mark.port

B, T, IGNORE = 2, 128, -100
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _pair(remat: bool, **cfg):
    """The JAX model from a key and the port's carrying its weights, both
    ``tiny()`` with ``remat`` and the other config fields ``cfg``."""
    jm = JaxLlama(dataclasses.replace(JaxConfig.tiny(), remat=remat, **cfg),
                  key=jax.random.PRNGKey(3))
    tm = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(),
                                              remat=remat, **cfg),
                          device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


def _loss_and_grads_match_jax(jm, tm, seed=0):
    ids, labels = _batch(seed)
    want, jgrads = jax.value_and_grad(
        lambda m: m.loss(jnp.asarray(ids), jnp.asarray(labels)))(jm)
    loss = tm.loss(_t(ids), _t(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = bridge.from_jax_state_dict(state_dict(jgrads), 2)
    got_g = bridge.grads_state_dict(tm)
    assert sorted(got_g) == sorted(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], **GRAD_TOL,
                                   err_msg=name)
    return got_g


def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, 256, (B, T)).astype(
        np.int32)
    labels = ids.copy()
    labels[0, 5:9] = IGNORE
    return ids, labels


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(remat):
    _loss_and_grads_match_jax(*_pair(remat))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("mode", ["fused", "chunked", "auto"])
def test_head_modes_match_jax(mode, tied):
    """Loss and every gradient through each head mode, untied and tied
    (the head weight is then the embedding transposed), against the JAX
    model in the same mode (on the CPU its fused mode runs the chunked
    arm and auto the dense one)."""
    _loss_and_grads_match_jax(*_pair(False, lm_head_mode=mode,
                                     tie_embeddings=tied))


@pytest.mark.parametrize("policy", scan.REMAT_POLICIES)
def test_remat_policies_match_no_remat_and_jax(policy):
    """Every recompute policy of the JAX package: the same loss and
    gradients as no recompute, and as the JAX model under that policy."""
    got = _loss_and_grads_match_jax(*_pair(True, remat_policy=policy),
                                    seed=1)
    _, plain = _pair(False)
    ids, labels = _batch(1)
    plain.loss(_t(ids), _t(labels)).backward()
    for name, g in bridge.grads_state_dict(plain).items():
        np.testing.assert_allclose(got[name], g, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_remat_policy_names_match_jax():
    from paddle_tpu.nn.scan import REMAT_POLICIES
    assert sorted(scan.REMAT_POLICIES) == sorted(REMAT_POLICIES)
    with pytest.raises(ValueError):
        scan.check_remat_policy("bogus")


def test_save_mlp_dots_keeps_the_gate_and_up_products():
    """Products by the MLP's gate and up weights (the projections, not
    their gradients, whose second factor is the output gradient): 2 a
    layer in the forward. Recomputing everything runs them again in
    backward; ``save_mlp_dots`` keeps their outputs and runs none; the
    gradients agree."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class GateUpProducts(TorchDispatchMode):
        def __init__(self, weights):
            super().__init__()
            self.weights = {(w.data_ptr(), w.stride()) for w in weights}
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default and (
                    args[1].data_ptr(), args[1].stride()) in self.weights:
                self.n += 1
            return func(*args, **(kwargs or {}))

    ids, labels = _batch(1)
    counts, grads = {}, {}
    for remat, policy in ((False, "nothing_saveable"),
                          (True, "nothing_saveable"), (True, "save_mlp_dots")):
        _, tm = _pair(remat, remat_policy=policy)
        weights = [lin.weight for b in tm.blocks
                   for lin in (b.mlp.gate, b.mlp.up)]
        fwd, bwd = GateUpProducts(weights), GateUpProducts(weights)
        with fwd:
            loss = tm.loss(_t(ids), _t(labels))
        with bwd:
            loss.backward()
        counts[remat, policy] = (fwd.n, bwd.n)
        grads[remat, policy] = bridge.grads_state_dict(tm)
    L = LlamaConfig.tiny().num_layers
    assert counts == {(False, "nothing_saveable"): (2 * L, 0),
                      (True, "nothing_saveable"): (2 * L, 2 * L),
                      (True, "save_mlp_dots"): (2 * L, 0)}
    for key in grads:
        for name, g in grads[key].items():
            np.testing.assert_allclose(
                g, grads[False, "nothing_saveable"][name], rtol=1e-6,
                atol=1e-7, err_msg=f"{key} {name}")


def test_remat_recomputes_each_block_in_backward(monkeypatch):
    """Under remat every block's forward runs again in backward: its two
    norms run twice, the final norm once (5 forwards without remat, 9
    with). Gradients are the same either way."""
    from paddle_tpu_torch.kernels import norm as N
    calls = []
    plain = N.rms_norm_reference

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(N, "rms_norm_reference", counted)
    grads, counts = {}, {}
    for remat in (False, True):
        _, tm = _pair(remat)
        calls.clear()
        ids, labels = _batch(1)
        tm.loss(_t(ids), _t(labels)).backward()
        counts[remat] = len(calls)
        grads[remat] = bridge.grads_state_dict(tm)
    assert counts == {False: 5, True: 9}
    for name in grads[False]:
        np.testing.assert_allclose(grads[True][name], grads[False][name],
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_backward_goes_through_the_kernel_functions():
    """Every kernel output on the path carries its autograd.Function."""
    _, tm = _pair(False)
    seen = set()

    def hook(_m, _i, out):
        seen.add(type(out.grad_fn).__name__)

    tm.norm.register_forward_hook(hook)
    tm.blocks[0].attn_norm.register_forward_hook(hook)
    ids, labels = _batch()
    tm.loss(_t(ids), _t(labels)).backward()
    assert seen == {"_RMSNormBackward"}
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    c, s = TF.rotary_embedding(torch.arange(8), 16)
    assert type(TF.apply_rotary(q, c, s).grad_fn).__name__ == \
        "_RotaryBackward"
    assert type(TF.scaled_dot_product_attention(
        q, q, q, causal=True).grad_fn).__name__ == "_FlashAttentionBackward"


SCHEDULE = (1e-4, 1, 10)       # warmup_cosine(peak, warmup, total)


# (lm_head_mode, remat_policy) of the step tests: the defaults, and
# bench.py's (fused head, save_mlp_dots_attn)
STEP_CONFIGS = [("dense", "nothing_saveable"), ("fused", "save_mlp_dots_attn")]


@pytest.fixture(scope="module")
def jax_run():
    return _jax_steps(*STEP_CONFIGS[0])


@functools.cache
def _jax_steps(head, policy):
    """Three JAX ``build_train_step`` steps from the remat model: per step
    the loss, grad_norm, port-named parameters and the AdamState as
    ``(count, mu, nu)`` of numpy copies (the step donates its state)."""
    jm, _ = _pair(True, lm_head_mode=head, remat_policy=policy)
    ids, labels = _batch(2)
    mesh = jax_mesh.create_mesh({"dp": 1}, devices=jax.devices()[:1])
    with jax_mesh.MeshContext(mesh):
        step = jax_dist.fleet.build_train_step(
            jm, optimizer=jax_optim.AdamW(
                jax_lr.warmup_cosine(*SCHEDULE),
                grad_clip=jax_optim.ClipGradByGlobalNorm(1.0)),
            mesh=mesh)
        state = step.init_state(jm)
        data = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}
        out = []
        for i in range(3):
            state, metrics = step(state, data, jax.random.PRNGKey(i))
            out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                        bridge.from_jax_state_dict(state_dict(state.model),
                                                   2),
                        _adam_numpy(state.opt_state)))
    return out


def _adam_numpy(opt_state):
    adam = next(s for s in opt_state if isinstance(s, AdamState))
    return (int(adam.count),
            {k: np.array(v) for k, v in state_dict(adam.mu).items()},
            {k: np.array(v) for k, v in state_dict(adam.nu).items()})


def _port_step(tm):
    return fleet.build_train_step(
        tm, optim.AdamW(lr.warmup_cosine(*SCHEDULE),
                        grad_clip=optim.ClipGradByGlobalNorm(1.0)))


def _data():
    ids, labels = _batch(2)
    return {"input_ids": _t(ids), "labels": _t(labels)}


def _assert_params(tm, want, msg):
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   atol=1e-6, rtol=0, err_msg=f"{msg} {name}")


def _assert_moments(opt_state, adam):
    count, mu, nu = bridge.adamw_state_to_jax(opt_state, 2)
    assert count == adam[0]
    for got, ref, atol in ((mu, adam[1], 1e-6), (nu, adam[2], 1e-10)):
        assert sorted(got) == sorted(ref)
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], atol=atol,
                                       rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("head,policy", STEP_CONFIGS)
def test_train_steps_match_jax(head, policy):
    jax_run = _jax_steps(head, policy)
    _, tm = _pair(True, lm_head_mode=head, remat_policy=policy)
    step = _port_step(tm)
    state = step.init_state(tm)
    for i, (loss, gnorm, params, _) in enumerate(jax_run):
        state, metrics = step(state, _data())
        np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm,
                                   rtol=1e-5)
        _assert_params(tm, params, f"step {i}")
    assert state.step == 3
    _assert_moments(state.opt_state, jax_run[-1][3])


def test_adamw_state_round_trips_through_the_bridge():
    jm, tm = _pair(False)
    rs = np.random.RandomState(4)
    mu = {k: rs.randn(*v.shape).astype(np.float32)
          for k, v in state_dict(jm).items()}
    nu = {k: rs.rand(*v.shape).astype(np.float32) for k, v in mu.items()}
    port = bridge.adamw_state_from_jax(7, mu, nu, tm)
    assert port.count == 7
    assert port.mu["blocks.1.mlp.up.weight"].dtype == torch.float32
    count, mu2, nu2 = bridge.adamw_state_to_jax(port, 2)
    assert count == 7
    for a, b in ((mu, mu2), (nu, nu2)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(KeyError):
        bridge.adamw_state_from_jax(7, {}, nu, tm)


def test_training_resumes_from_jax_weights_and_optimizer_state(jax_run):
    """The JAX run's weights and AdamState after step 2 carried across:
    the port's third step lands on the JAX package's third step."""
    _, tm = _pair(True)
    _, _, params, adam = jax_run[1]
    bridge.load_jax_state_dict(tm, bridge.to_jax_state_dict(params, 2))
    state = fleet.TrainState(tm, bridge.adamw_state_from_jax(*adam, tm), 2)
    state, metrics = _port_step(tm)(state, _data())
    loss, gnorm, params, adam = jax_run[2]
    np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm, rtol=1e-5)
    _assert_params(tm, params, "resumed step")
    _assert_moments(state.opt_state, adam)


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rs = np.random.RandomState(5)
    logits = rs.randn(3, 7, 50).astype(np.float32) * 3
    label = rs.randint(0, 50, (3, 7))
    label[1, 2:5] = IGNORE
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                           reduction=reduction).numpy()
    want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label),
                            reduction=reduction)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "fused", "chunked", "auto"])
def test_next_token_linear_loss_matches_jax(mode):
    rs = np.random.RandomState(6)
    h, w = rs.randn(2, 9, 16).astype(np.float32), \
        rs.randn(16, 40).astype(np.float32)
    labels = rs.randint(0, 40, (2, 9))
    labels[1, 4] = IGNORE
    got = TF.next_token_linear_loss(torch.from_numpy(h), torch.from_numpy(w),
                                    torch.from_numpy(labels), mode=mode)
    want = JF.next_token_linear_loss(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(labels), mode=mode)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError):
        TF.next_token_linear_loss(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(labels), mode="bogus")


@pytest.mark.parametrize("section", ["sharding", "pipeline", "amp",
                                     "gradient_merge", "tensor_parallel",
                                     "recompute"])
def test_strategy_sections_raise(section):
    """Every strategy section raises; recompute is the model's config."""
    _, tm = _pair(False)
    strategy = DistributedStrategy()
    getattr(strategy, section).enable = True
    with pytest.raises(NotImplementedError, match=section):
        fleet.build_train_step(tm, optim.AdamW(1e-3), strategy=strategy)
    assert not tm.config.remat


@pytest.mark.parametrize("step", [0, 1, 3, 7, 10, 57, 100, 150])
def test_schedules_match_jax(step):
    pairs = [(lr.warmup_cosine(3e-4, 100, 10000),
              jax_lr.warmup_cosine(3e-4, 100, 10000)),
             (lr.warmup_cosine(1e-3, 3, 60, end_lr=1e-5),
              jax_lr.warmup_cosine(1e-3, 3, 60, end_lr=1e-5)),
             (lr.CosineAnnealingDecay(0.1, 50, 0.01),
              jax_lr.CosineAnnealingDecay(0.1, 50, 0.01)),
             (lr.LinearWarmup(0.05, 10, start_lr=0.01),
              jax_lr.LinearWarmup(0.05, 10, start_lr=0.01))]
    for port, ref in pairs:
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6)


def test_global_norm_clip_matches_jax():
    rs = np.random.RandomState(7)
    arrays = [rs.randn(*s).astype(np.float32) for s in ((5, 3), (7,), (2, 2))]
    jnorm = jax_optim.global_norm([jnp.asarray(a) for a in arrays])
    for max_norm in (0.5, 100.0):
        tensors = [torch.from_numpy(a.copy()) for a in arrays]
        norm = optim.ClipGradByGlobalNorm(max_norm)(tensors)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        clipped, _ = jax_optim.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in arrays], ())
        for t, c in zip(tensors, clipped):
            np.testing.assert_allclose(t.numpy(), np.asarray(c), rtol=1e-6)


def test_adamw_decay_mask_spares_unmasked_parameters():
    _, tm = _pair(False)
    norms = {n: p.detach().clone() for n, p in tm.named_parameters()
             if n.endswith("norm.weight")}
    opt = optim.AdamW(1e-2, weight_decay=0.5,
                      decay_mask=lambda name: not name.endswith("norm.weight"))
    state = opt.init(tm)
    zero = {n: torch.zeros_like(p) for n, p in tm.named_parameters()}
    _, state = opt.apply_gradients(tm, zero, state)
    params = dict(tm.named_parameters())
    for n, before in norms.items():
        torch.testing.assert_close(params[n].detach(), before, rtol=0, atol=0)
    w = params["blocks.0.mlp.up.weight"].detach()
    assert state.count == 1 and w.abs().sum() > 0


def test_cpu_training_step_launches_no_kernel():
    _support.reset_launches()
    _, tm = _pair(True)
    step = fleet.build_train_step(tm, optim.AdamW(1e-3))
    state = step.init_state(tm)
    ids, labels = _batch()
    state, metrics = step(state, {"input_ids": _t(ids), "labels": _t(labels)})
    assert np.isfinite(metrics["loss"].item())
    assert all(n == 0 for n in _support.LAUNCHES.values())
