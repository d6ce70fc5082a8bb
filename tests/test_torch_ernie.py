"""The port's ERNIE family against the JAX package, on the CPU.

``ErnieConfig.tiny()`` (hidden 64, 4 heads, 2 layers, fp32, dropout 0) is
built in the JAX package from a key and carried into the port by
``bridge.py``, whose scanned stack is nested (``ernie.blocks.block.*``).
``(seq, pooled)`` and ``(mlm_logits, sop_logits)`` agree within 2e-5
abs/rel; the loss, with and without the sentence-order term, within rtol
1e-5 and every gradient within atol 1e-5 / rtol 1e-4; two
``build_train_step`` steps against the JAX step.

Two things the JAX package does not show: dropout replayed under
recompute (``ErnieConfig.ernie3_xl()`` has both), and ``attention_mask``
with Paddle's semantics, where the JAX package has a fault that a test
here pins.
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
from paddle_tpu.models.ernie import ErnieConfig as JaxConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JaxErnie
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.parallel import mesh as jax_mesh

from paddle_tpu_torch import bridge, optimizer as optim
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
from paddle_tpu_torch.nn import scan
from paddle_tpu_torch.optimizer import lr

pytestmark = pytest.mark.port

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
L, V, T = 2, 256, 24
SCHEDULE = (1e-4, 1, 10)


def _pair(**cfg):
    jm = JaxErnie(dataclasses.replace(JaxConfig.tiny(), **cfg),
                  key=jax.random.PRNGKey(7))
    tm = ErnieForPretraining(dataclasses.replace(ErnieConfig.tiny(), **cfg),
                             device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(seed=0, B=2):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, T)).astype(np.int32)
    types = rs.randint(0, 2, (B, T)).astype(np.int32)
    labels = np.where(rs.rand(B, T) < 0.3, ids, -100).astype(np.int32)
    labels[:, 0] = ids[:, 0]              # at least one label per row
    sop = rs.randint(0, 2, (B,)).astype(np.int32)
    return ids, types, labels, sop


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_configs_match_jax():
    for name in ("base", "large", "ernie3_xl", "tiny"):
        mine, ref = getattr(ErnieConfig, name)(), getattr(JaxConfig, name)()
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), name


def test_state_dict_names_and_shapes_match_jax(pair):
    jm, tm = pair
    want = bridge.from_jax_state_dict(state_dict(jm), L)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
    assert "ernie.blocks.1.wqkv.weight" in got


def test_backbone_outputs_match(pair):
    jm, tm = pair
    ids, types, _, _ = _batch()
    jseq, jpooled = jm.ernie(jnp.asarray(ids), jnp.asarray(types))
    with torch.no_grad():
        seq, pooled = tm.ernie(_t(ids), _t(types))
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)


def test_pretraining_logits_match(pair):
    jm, tm = pair
    ids, types, _, _ = _batch(1)
    jmlm, jsop = jm(jnp.asarray(ids), jnp.asarray(types))
    with torch.no_grad():
        mlm, sop = tm(_t(ids), _t(types))
    assert mlm.shape == (2, T, V) and sop.shape == (2, 2)
    np.testing.assert_allclose(mlm.numpy(), np.asarray(jmlm), **TOL)
    np.testing.assert_allclose(sop.numpy(), np.asarray(jsop), **TOL)


@pytest.mark.parametrize("with_sop", [False, True])
def test_loss_and_every_gradient_match_jax(with_sop):
    jm, tm = _pair()
    ids, types, labels, sop = _batch(2)
    kw = dict(token_type_ids=types, sop_labels=sop if with_sop else None)
    want, jgrads = jax.value_and_grad(lambda m: m.loss(
        jnp.asarray(ids), jnp.asarray(labels),
        **{k: None if v is None else jnp.asarray(v)
           for k, v in kw.items()}))(jm)
    loss = tm.loss(_t(ids), _t(labels),
                   **{k: None if v is None else _t(v)
                      for k, v in kw.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = bridge.from_jax_state_dict(state_dict(jgrads), L)
    got_g = bridge.grads_state_dict(tm)
    assert sorted(got_g) == sorted(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], **GRAD_TOL,
                                   err_msg=name)
    pooler = got_g["ernie.pooler.weight"]
    assert (np.abs(pooler).max() > 0) == with_sop


def test_two_train_steps_match_jax():
    """Two ``build_train_step`` steps with the MLM and SOP losses (the
    port's default loss passes the batch's ``sop_labels`` on; the JAX step
    takes a loss_fn that does): loss, grad_norm and every parameter."""
    jm, tm = _pair()
    ids, types, labels, sop = _batch(3)

    def jloss(m, b, training=True):
        return m.loss(b["input_ids"], b["labels"],
                      sop_labels=b["sop_labels"], training=training)
    mesh = jax_mesh.create_mesh({"dp": 1}, devices=jax.devices()[:1])
    with jax_mesh.MeshContext(mesh):
        jstep = jax_dist.fleet.build_train_step(
            jm, optimizer=jax_optim.AdamW(
                jax_lr.warmup_cosine(*SCHEDULE),
                grad_clip=jax_optim.ClipGradByGlobalNorm(1.0)),
            loss_fn=jloss, mesh=mesh)
        jstate = jstep.init_state(jm)
        data = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels),
                "sop_labels": jnp.asarray(sop)}
        want = []
        for i in range(2):
            jstate, metrics = jstep(jstate, data, jax.random.PRNGKey(i))
            want.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                         bridge.from_jax_state_dict(state_dict(jstate.model),
                                                    L)))
    step = fleet.build_train_step(tm, optim.AdamW(
        lr.warmup_cosine(*SCHEDULE),
        grad_clip=optim.ClipGradByGlobalNorm(1.0)))
    state = step.init_state(tm)
    batch = {"input_ids": _t(ids), "labels": _t(labels),
             "sop_labels": _t(sop)}
    for i, (loss, gnorm, params) in enumerate(want):
        state, metrics = step(state, batch)
        np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm,
                                   rtol=1e-5)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), params[name],
                                       atol=1e-6, rtol=0,
                                       err_msg=f"step {i} {name}")


def _dropout_grads(remat: bool, seed: int = 11):
    """Every gradient of ERNIE tiny with dropout 0.1 (``ernie3_xl``'s
    rate and recompute), from a generator seeded with ``seed``."""
    _, tm = _pair(dropout=0.1, remat=remat)
    ids, types, labels, sop = _batch(4)
    tm.loss(_t(ids), _t(labels), token_type_ids=_t(types),
            sop_labels=_t(sop),
            generator=torch.Generator().manual_seed(seed)).backward()
    return bridge.grads_state_dict(tm)


def test_recompute_replays_dropout(monkeypatch):
    """With dropout on, recompute gives the gradients of no recompute:
    each block's recompute draws the masks its forward drew. Without the
    replay (the generator left where the forward ran it) they differ."""
    plain = _dropout_grads(False)
    remat = _dropout_grads(True)
    for name, g in plain.items():
        np.testing.assert_allclose(remat[name], g, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    monkeypatch.setattr(scan, "_replaying", lambda block, generator: block)
    unreplayed = _dropout_grads(True)
    worst = max(np.abs(unreplayed[n] - g).max() for n, g in plain.items())
    assert worst > 1e-3


def test_recompute_leaves_the_generator_where_the_forward_did():
    """After backward the caller's generator is where a forward without
    recompute leaves it, so the next step draws fresh masks."""
    states = []
    for remat in (False, True):
        _, tm = _pair(dropout=0.1, remat=remat)
        ids, _, labels, _ = _batch(5)
        gen = torch.Generator().manual_seed(3)
        tm.loss(_t(ids), _t(labels), generator=gen).backward()
        states.append(gen.get_state())
    assert torch.equal(*states)


def test_train_step_seeds_dropout_per_step():
    """The training step draws dropout from a generator seeded with the
    step count: two runs from the same weights read the same losses, a
    generator the caller passes takes its place, and another seed gives
    another loss."""
    ids, types, labels, sop = _batch(6)
    batch = {"input_ids": _t(ids), "labels": _t(labels),
             "sop_labels": _t(sop)}

    def losses(generators):
        _, tm = _pair(dropout=0.1)
        step = fleet.build_train_step(tm, optim.AdamW(1e-3))
        state = step.init_state(tm)
        out = []
        for gen in generators:
            state, metrics = step(state, batch, gen)
            out.append(metrics["loss"].item())
        return out

    default = losses([None, None])
    assert default == losses([None, None])
    assert default == losses([torch.Generator().manual_seed(0),
                              torch.Generator().manual_seed(1)])
    assert default[0] != losses([torch.Generator().manual_seed(5)])[0]


# ------------------------------------------------------ attention_mask

def test_reference_fault_all_ones_mask_makes_attention_uniform():
    """The JAX package's fault (``paddle_tpu/models/ernie.py:138-141``
    makes the additive mask ``(1 - m) * -1e9``; ``paddle_tpu/nn/
    functional.py:606-607`` reads ``mask`` as a boolean keep-mask): with
    an all-ones ``attention_mask`` every key's mask value is 0.0, so every
    key is dropped and attention is uniform — the output equals the mean
    of v — and the model's output differs from the unmasked one (weights
    at std 0.5, so that attention is far from uniform without the
    mask)."""
    jm, _ = _pair(init_std=0.5)
    ids = _batch(6)[0]
    ones = jnp.ones(ids.shape, jnp.float32)
    masked, _ = jm.ernie(jnp.asarray(ids), attention_mask=ones)
    plain, _ = jm.ernie(jnp.asarray(ids))
    assert np.abs(np.asarray(masked) - np.asarray(plain)).max() > 0.1
    rs = np.random.RandomState(8)
    q, k, v = (jnp.asarray(rs.randn(2, 6, 4, 16).astype(np.float32))
               for _ in range(3))
    additive = (1.0 - ones[:, None, None, :6]) * -1e9
    out = JF.scaled_dot_product_attention(q, k, v, mask=additive)
    uniform = jnp.broadcast_to(v.mean(axis=1, keepdims=True), v.shape)
    np.testing.assert_allclose(np.asarray(out), np.asarray(uniform), **TOL)


def test_port_mask_keeps_real_tokens_and_ignores_padding():
    """The port follows Paddle: an all-ones ``attention_mask`` changes
    nothing, and padded keys appended after the real tokens (mask 0) leave
    every real token's output and the pooled output as they were (weights
    at std 0.5, so that attention is far from uniform)."""
    _, tm = _pair(init_std=0.5)
    ids, types, _, _ = _batch(7)
    with torch.no_grad():
        seq, pooled = tm.ernie(_t(ids), _t(types))
        ones = torch.ones(ids.shape, dtype=torch.long)
        mseq, mpooled = tm.ernie(_t(ids), _t(types), attention_mask=ones)
        pad = np.random.RandomState(9).randint(0, V, (2, 6))
        pids = np.concatenate([ids, pad], 1)
        ptypes = np.concatenate([types, np.zeros_like(pad)], 1)
        pmask = torch.cat([ones, torch.zeros(2, 6, dtype=torch.long)], 1)
        pseq, ppooled = tm.ernie(_t(pids), _t(ptypes), attention_mask=pmask)
    np.testing.assert_allclose(mseq.numpy(), seq.numpy(), **TOL)
    np.testing.assert_allclose(mpooled.numpy(), pooled.numpy(), **TOL)
    np.testing.assert_allclose(pseq[:, :T].numpy(), seq.numpy(), **TOL)
    np.testing.assert_allclose(ppooled.numpy(), pooled.numpy(), **TOL)


def test_bridge_round_trips_the_nested_stack_and_moments(pair):
    jm, tm = pair
    sd = {k: np.asarray(v) for k, v in state_dict(jm).items()}
    assert "ernie.blocks.block.wqkv.weight" in sd
    back = bridge.to_jax_state_dict(bridge.from_jax_state_dict(sd, L), L)
    assert sorted(back) == sorted(sd)
    for name in sd:
        np.testing.assert_array_equal(back[name], sd[name])
    rs = np.random.RandomState(10)
    mu = {k: rs.randn(*v.shape).astype(np.float32) for k, v in sd.items()}
    nu = {k: rs.rand(*v.shape).astype(np.float32) for k, v in sd.items()}
    port = bridge.adamw_state_from_jax(2, mu, nu, tm)
    assert port.mu["ernie.blocks.1.ffn_ln.bias"].shape == (64,)
    count, mu2, nu2 = bridge.adamw_state_to_jax(port, L)
    assert count == 2
    for a, b in ((mu, mu2), (nu, nu2)):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    with pytest.raises(KeyError, match="unexpected"):
        bridge.load_jax_state_dict(tm, dict(sd, **{"sop_head.extra": sd[
            "sop_head.bias"]}))
    with pytest.raises(KeyError, match="missing"):
        bridge.adamw_state_from_jax(
            2, mu, {k: v for k, v in nu.items() if k != "mlm_ln.bias"}, tm)
