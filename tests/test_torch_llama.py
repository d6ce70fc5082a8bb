"""The port's Llama serving path against the JAX package, on the CPU.

Two small models — ``LlamaConfig.tiny()`` (head_dim 16, 4 heads, 2 kv
heads) and a head_dim-64 GQA model (hidden 128, 2 heads, 1 kv head) —
are built in the JAX package from a key and carried into the port by
``bridge.py``. Logits (``__call__``, prefill, decode) agree within 2e-5
abs/rel in fp32: the same arithmetic in another summation order. Greedy
``generate`` is token-exact (both argmaxes return the first maximum).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models import generation as jax_generation
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import bridge
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     filter_logits, sample_logits)

pytestmark = pytest.mark.port

TOL = dict(rtol=2e-5, atol=2e-5)
CONFIGS = {"tiny": {}, "gqa64": dict(hidden_size=128, num_heads=2,
                                     num_kv_heads=1)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    kw = CONFIGS[request.param]
    jm = JaxLlama(JaxConfig.tiny(**kw), key=jax.random.PRNGKey(3))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


def _ids(B=2, T=12, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, T)).astype(
        np.int32)


def test_call_logits_match(pair):
    jm, tm = pair
    ids = _ids()
    want = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 12, 256)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_and_decode_logits_match(pair):
    jm, tm = pair
    ids = _ids(T=10, seed=1)
    jc = jm.init_cache(2, 16)
    tc = tm.init_cache(2, 16)
    jl, jc = jm.forward_with_cache(jnp.asarray(ids), jc, 0)
    tl, tc = tm.forward_with_cache(torch.from_numpy(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for step in range(3):
        tok = ids[:, step:step + 1]
        jl, jc = jm.forward_with_cache(jnp.asarray(tok), jc, 10 + step)
        tl, tc = tm.forward_with_cache(torch.from_numpy(tok), tc, 10 + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")


def test_cache_write_is_in_place(pair):
    _, tm = pair
    cache = tm.init_cache(1, 8)
    ptrs = [c.data_ptr() for c in cache]
    _, out = tm.forward_with_cache(torch.from_numpy(_ids(B=1, T=3)), cache, 0)
    assert [c.data_ptr() for c in out] == ptrs
    assert out[0][:, :, :, :3].abs().sum() > 0
    assert out[0][:, :, :, 3:].abs().sum() == 0


def test_hidden_states_feed_the_head(pair):
    _, tm = pair
    ids = torch.from_numpy(_ids())
    with torch.no_grad():
        h = tm.hidden_states(ids)
        np.testing.assert_allclose((h @ tm.lm_head.weight).numpy(),
                                   tm(ids).numpy(), **TOL)


def test_greedy_generate_token_exact(pair):
    jm, tm = pair
    ids = _ids(seed=2)
    want = np.asarray(jax_generation.generate(jm, jnp.asarray(ids), 9))
    got = tm.generate(torch.from_numpy(ids), 9).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_eos_and_pad(pair):
    """EOS taken from the JAX stream itself, so one row stops early and the
    rest of it must be pad."""
    jm, tm = pair
    ids = _ids(seed=4)
    free = np.asarray(jax_generation.generate(jm, jnp.asarray(ids), 8))
    eos = int(free[0, 12 + 2])
    want = np.asarray(jax_generation.generate(
        jm, jnp.asarray(ids), 8, eos_token_id=eos, pad_token_id=7))
    got = tm.generate(torch.from_numpy(ids), 8, eos_token_id=eos,
                      pad_token_id=7).numpy()
    np.testing.assert_array_equal(got, want)
    stop = int(np.argmax(got[0, 12:] == eos))
    assert (got[0, 12 + stop + 1:] == 7).all()


def test_generate_stops_once_every_row_finished(pair):
    """Single row with EOS = its first token: one forward (the prefill)
    and no decode step."""
    jm, tm = pair
    ids = _ids(B=1, seed=5)
    first = int(tm.generate(torch.from_numpy(ids), 1)[0, -1])
    calls = []
    orig = tm.forward_with_cache

    def counted(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)

    tm.forward_with_cache = counted
    try:
        got = tm.generate(torch.from_numpy(ids), 6, eos_token_id=first,
                          pad_token_id=0).numpy()
    finally:
        del tm.forward_with_cache
    assert calls == [0]
    want = np.asarray(jax_generation.generate(
        jm, jnp.asarray(ids), 6, eos_token_id=first, pad_token_id=0))
    np.testing.assert_array_equal(got, want)


def test_generate_zero_new_tokens_returns_prompt(pair):
    _, tm = pair
    ids = _ids()
    np.testing.assert_array_equal(
        tm.generate(torch.from_numpy(ids), 0).numpy(), ids)


def _jax_filtered(logits, monkeypatch, **kw):
    """The JAX package's filtered logits, caught at its draw."""
    seen = {}

    def catch(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", catch)
    jax_generation.sample_logits(jnp.asarray(logits),
                                 jax.random.PRNGKey(0), **kw)
    return seen["logits"]


@pytest.mark.parametrize("kw", [dict(temperature=0.7, top_k=5),
                                dict(temperature=1.3, top_p=0.6),
                                dict(temperature=1.0, top_k=20, top_p=0.9),
                                dict(temperature=0.5)])
def test_filter_matches_jax_masks(kw, monkeypatch):
    logits = np.random.RandomState(6).randn(3, 64).astype(np.float32) * 3
    logits[1, 10] = logits[1, 11] = logits[1].max() + 1   # a tie at the top
    want = _jax_filtered(logits, monkeypatch, **kw)
    got = filter_logits(torch.from_numpy(logits), **kw).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = ~np.isinf(want)
    np.testing.assert_allclose(got[finite], want[finite], **TOL)


def test_sampled_stream_deterministic_per_seed(pair):
    _, tm = pair
    ids = torch.from_numpy(_ids(seed=7))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tm.generate(ids, 10, temperature=1.0, top_k=50, top_p=0.95,
                           generator=gen).numpy()

    a, b, c = run(11), run(11), run(12)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_top_k_one_sampling_is_greedy(pair):
    _, tm = pair
    ids = torch.from_numpy(_ids(seed=8))
    greedy = tm.generate(ids, 6).numpy()
    sampled = tm.generate(ids, 6, temperature=0.8, top_k=1,
                          generator=torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_array_equal(sampled, greedy)


def test_sample_logits_greedy_without_generator():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0]])
    assert sample_logits(logits).tolist() == [1]     # first maximum
    assert sample_logits(logits, torch.Generator(),
                         temperature=0.0).tolist() == [1]


def test_bridge_round_trip(pair):
    jm, tm = pair
    sd = state_dict(jm)
    port = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = bridge.to_jax_state_dict(port, tm.config.num_layers)
    assert sorted(back) == sorted(sd)
    for name in sd:
        np.testing.assert_array_equal(back[name], sd[name], err_msg=name)


def test_bridge_unstacks_layers():
    sd = {"blocks.block.attn.wq.weight": np.arange(2 * 3 * 4).reshape(
        2, 3, 4), "embed.weight": np.ones((5, 3))}
    out = bridge.from_jax_state_dict(sd, 2)
    assert sorted(out) == ["blocks.0.attn.wq.weight",
                           "blocks.1.attn.wq.weight", "embed.weight"]
    np.testing.assert_array_equal(out["blocks.1.attn.wq.weight"],
                                  sd["blocks.block.attn.wq.weight"][1])
    with pytest.raises(ValueError):
        bridge.from_jax_state_dict(sd, 3)


def test_bridge_rejects_mismatched_names(pair):
    jm, tm = pair
    sd = dict(state_dict(jm))
    sd.pop("norm.weight")
    with pytest.raises(KeyError):
        bridge.load_jax_state_dict(tm, sd)


def test_bf16_model_builds_from_seed():
    cfg = LlamaConfig.tiny()
    a = LlamaForCausalLM(cfg, device="cpu", dtype="bfloat16",
                         generator=torch.Generator().manual_seed(5))
    b = LlamaForCausalLM(cfg, device="cpu", dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(5))
    assert a.embed.weight.dtype == torch.bfloat16
    for (n, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q), n
    assert sum(p.numel() for p in a.parameters()) == cfg.num_params()
    out = a.generate(torch.from_numpy(_ids()), 3)
    assert out.shape == (2, 15) and out.dtype == torch.long


def test_config_presets_match_jax():
    """Every field the two configs share, for every preset."""
    import dataclasses
    shared = ({f.name for f in dataclasses.fields(JaxConfig)}
              & {f.name for f in dataclasses.fields(LlamaConfig)})
    assert {"remat", "remat_policy", "lm_head_mode", "max_seq_len",
            "tie_embeddings", "init_std"} <= shared
    for name in ("llama2_7b", "llama2_70b", "tiny"):
        j, t = getattr(JaxConfig, name)(), getattr(LlamaConfig, name)()
        for f in sorted(shared):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.num_params() == j.num_params()


# ------------------------------------------------------------ int8 cache

def test_int8_cache_layout_matches_jax(pair):
    """``init_cache(dtype=torch.int8)``: int8 k/v [L, B, Hkv, S, D] and
    fp32 per-position scales [L, B, Hkv, S], as the JAX package's."""
    jm, tm = pair
    got, want = tm.init_cache(2, 16, torch.int8), jm.init_cache(2, 16,
                                                                 jnp.int8)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)


def test_int8_prefill_and_decode_match_jax(pair):
    """Prefill (flash over the raw chunk, the payload quantized) and three
    decode steps (the int8 plain version) against the JAX package's, fp32:
    logits within 2e-5, the int8 leaves equal and the scales within 1e-5
    (the same absmax quantization of k/v that agree to fp32 rounding)."""
    jm, tm = pair
    ids = _ids(T=10, seed=6)
    jl, jc = jm.forward_with_cache(jnp.asarray(ids),
                                   jm.init_cache(2, 16, jnp.int8), 0)
    tl, tc = tm.forward_with_cache(torch.from_numpy(ids),
                                   tm.init_cache(2, 16, torch.int8), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for step in range(3):
        tok = ids[:, step:step + 1]
        jl, jc = jm.forward_with_cache(jnp.asarray(tok), jc, 10 + step)
        tl, tc = tm.forward_with_cache(torch.from_numpy(tok), tc, 10 + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
    for a, b in zip(tc[:2], jc[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tc[2:], jc[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_int8_generate_token_exact(pair):
    jm, tm = pair
    ids = _ids(seed=7)
    want = np.asarray(jax_generation.generate(jm, jnp.asarray(ids), 9,
                                              cache_dtype=jnp.int8))
    got = tm.generate(torch.from_numpy(ids), 9,
                      cache_dtype=torch.int8).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_generate_token_exact_gpt():
    from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    jm = JaxGPT(JaxGPTConfig.tiny(), key=jax.random.PRNGKey(8))
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    ids = _ids(seed=8)
    want = np.asarray(jax_generation.generate(jm, jnp.asarray(ids), 9,
                                              cache_dtype=jnp.int8))
    got = tm.generate(torch.from_numpy(ids), 9,
                      cache_dtype=torch.int8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.int16])
def test_other_integer_cache_types_raise(pair, dtype):
    """Only int8 has a quantized layout; another integer type would
    truncate k/v on the write, so it raises, as in the JAX package."""
    _, tm = pair
    with pytest.raises(ValueError, match="unsupported"):
        tm.init_cache(1, 8, dtype)
    with pytest.raises(ValueError, match="unsupported"):
        tm.generate(torch.from_numpy(_ids(B=1)), 2, cache_dtype=dtype)
