"""The port's continuous-batching ``GenerationEngine`` against the JAX
package on the CPU.

A small Llama (V = 96, E = 32, 2 layers, 2 heads, ``max_seq_len`` 64,
fp32) is built in the JAX package from a key and carried into the port by
``bridge.py``. The assertions are those of the JAX engine's own tests
(``tests/test_generation_engine.py:77-248, 319-417`` and
``tests/test_paged_cache.py``), with the reference streams from the JAX
package's solo ``generate``: every greedy stream through the port's
engine — contiguous or paged, co-tenants admitted and retired mid-flight,
prompts right-padded to their bucket, prefix pages shared, prompts
prefilled in 3-token chunks — equals JAX solo ``generate`` token for
token. Sampled streams are compared with themselves only (threefry
against Philox).

Every engine here is closed by its fixture or ``with`` block, and every
wait is bounded (``_drain`` gives up after 60 s), so a fault cannot hang
the run.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models import generation as jax_generation
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import bridge
from paddle_tpu_torch.core import fault
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.core.monitor import get_histogram, get_stat
from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.generation import advance_generator, stream_seed
from paddle_tpu_torch.serving import (EngineOverloaded, GenerationEngine,
                                      GenerationExpired)
from paddle_tpu_torch.serving.engine import _PagePool, _PrefixCache

pytestmark = pytest.mark.port

VOCAB = 96
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
           num_kv_heads=2, max_seq_len=64)


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(JaxConfig.tiny(**CFG), key=jax.random.PRNGKey(7))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


def _solo(jm, prompt, n, **kw):
    """JAX solo ``generate``'s new tokens for one prompt."""
    out = jax_generation.generate(jm, np.asarray(prompt)[None], n, **kw)
    return np.asarray(out)[0, len(prompt):]


@pytest.fixture(scope="module")
def engine(pair):
    with GenerationEngine(pair[1], slots=3, max_len=32, queue_max=4,
                          ttl_s=10.0) as eng:
        yield eng


@pytest.fixture(scope="module")
def paged_engine(pair):
    """8-token pages and 3-token prefill chunks (page- and
    chunk-misaligned prompts), the pool sized to the contiguous
    layout's."""
    with GenerationEngine(pair[1], slots=3, max_len=32, queue_max=32,
                          ttl_s=10.0, paged=True, page_tokens=8,
                          prefill_chunk=3) as eng:
        yield eng


def _drain(engine, gen_id, wait_s=0.5, timeout=60.0):
    toks, n = [], 0
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = engine.poll(gen_id, start=n, wait_s=wait_s)
        toks += doc["tokens"]
        n = len(toks)
        if doc["done"]:
            return toks, doc["error"]
    raise AssertionError(f"generation {gen_id} did not finish in "
                         f"{timeout} s")


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _concurrent(engine, prompts, n):
    out = {}

    def worker(i):
        gid = None
        deadline = time.monotonic() + 60.0
        while gid is None and time.monotonic() < deadline:
            try:
                gid = engine.start(prompts[i], n)
            except EngineOverloaded as e:
                time.sleep(e.retry_after_s)
        out[i] = _drain(engine, gid)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    [t.start() for t in threads]
    [t.join(timeout=90.0) for t in threads]
    return out


# ------------------------------------------------------- contiguous mode

def test_interleaved_matches_solo_generate(pair, engine):
    """8 concurrent greedy generations through 3 slots (queueing forces
    admits and retires mid-flight) equal JAX solo generate."""
    jm, _ = pair
    prompts = np.random.RandomState(1).randint(0, VOCAB, (8, 6)).astype(
        np.int32)
    out = _concurrent(engine, prompts, 5)
    for i in range(8):
        toks, err = out[i]
        assert err is None
        np.testing.assert_array_equal(toks, _solo(jm, prompts[i], 5),
                                      err_msg=f"request {i}")
    st = engine.stats()
    assert st["active"] == 0 and st["queued"] == 0
    assert st["cuda_graph"] is False and st["device"] == "cpu"


def test_variable_lengths_and_late_admit(pair, engine):
    """Prompt lengths of other buckets and a late admit into a freed slot
    still equal solo generate."""
    jm, _ = pair
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, VOCAB, (n,)).astype(np.int32)
               for n in (3, 9, 5)]
    # the references first: a JAX compile between the starts and the
    # polls could outlast the poll TTL of the generations not yet polled
    refs = [_solo(jm, p, 4) for p in prompts]
    gids = [engine.start(p, 4) for p in prompts]
    for ref, gid in zip(refs, gids):
        toks, err = _drain(engine, gid)
        assert err is None
        np.testing.assert_array_equal(toks, ref)


def test_eos_retires_slot_early(pair, engine):
    jm, _ = pair
    prompt = np.random.RandomState(3).randint(0, VOCAB, (6,)).astype(
        np.int32)
    ref = _solo(jm, prompt, 6)
    eos = int(ref[2])                              # finish after 3 tokens
    first = int(np.argmax(ref == eos))
    toks, err = _drain(engine, engine.start(prompt, 6, eos_token_id=eos))
    assert err is None
    np.testing.assert_array_equal(toks, ref[:first + 1])
    assert _wait(lambda: engine.stats()["active"] == 0)


def test_cancel_frees_slot_others_uninterrupted(pair, engine):
    jm, _ = pair
    rs = np.random.RandomState(4)
    p_a = rs.randint(0, VOCAB, (5,)).astype(np.int32)
    p_b = rs.randint(0, VOCAB, (5,)).astype(np.int32)
    ref_b = _solo(jm, p_b, 10)
    ev0 = get_stat("gen/evictions")
    engine.step_wait_s = 0.02     # pace the loop so "mid-flight" exists
    try:
        gid_a = engine.start(p_a, 20)
        gid_b = engine.start(p_b, 10)
        assert _wait(lambda: len(engine.poll(gid_a)["tokens"]) >= 2)
        assert engine.cancel(gid_a)
        toks_b, err_b = _drain(engine, gid_b)
    finally:
        engine.step_wait_s = 0.0
    assert err_b is None
    np.testing.assert_array_equal(toks_b, ref_b)
    assert gid_a not in engine._gens               # cancelled gens drop
    assert get_stat("gen/evictions") == ev0 + 1
    assert not engine.cancel(gid_a)
    assert _wait(lambda: engine.stats()["active"] == 0)


def test_full_engine_sheds_start(pair, engine):
    """Slots busy and the queue at queue_max → EngineOverloaded with a
    retry hint; capacity returns once generations are cancelled."""
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, VOCAB, (4,)).astype(np.int32)
               for _ in range(7)]
    engine.step_wait_s = 0.03
    try:
        gids = [engine.start(p, 25) for p in prompts]   # 3 run + 4 queue
        assert _wait(lambda: engine.stats()["active"] == 3
                     and engine.stats()["queued"] >= 4)
        with pytest.raises(EngineOverloaded) as ei:
            engine.start(prompts[0], 25)
        assert ei.value.retry_after_s > 0
        for g in gids:
            engine.cancel(g)
    finally:
        engine.step_wait_s = 0.0
    assert _wait(lambda: engine.stats()["active"] == 0
                 and engine.stats()["queued"] == 0)
    toks, err = _drain(engine, engine.start(prompts[0], 2))
    assert err is None and len(toks) == 2


def test_poll_ttl_reaps_disconnected_client(engine):
    """A generation whose client stops polling is evicted after the TTL;
    a late poll gets the typed GenerationExpired."""
    old = engine._ttl_s
    engine._ttl_s = 0.3
    engine.step_wait_s = 0.05
    try:
        gid = engine.start(np.random.RandomState(6).randint(
            0, VOCAB, (4,)).astype(np.int32), 25)
        assert _wait(lambda: engine.stats()["active"] == 1)
        ev0 = get_stat("gen/evictions")
        assert _wait(lambda: engine.stats()["active"] == 0
                     and engine.stats()["generations"] == 0)
        assert get_stat("gen/evictions") >= ev0 + 1
        with pytest.raises(GenerationExpired):
            engine.poll(gid)
        with pytest.raises(KeyError, match="unknown"):
            engine.poll("deadbeef")
    finally:
        engine._ttl_s = old
        engine.step_wait_s = 0.0


def test_sampled_generation_is_per_request_deterministic(engine):
    """The same (prompt, seed) gives the same stream whatever the
    co-tenants; another seed gives another stream."""
    prompt = np.random.RandomState(7).randint(0, VOCAB, (5,)).astype(
        np.int32)
    runs = []
    for seed in (42, 42, 43):
        gids = [engine.start(prompt, 6, temperature=0.8, top_k=7,
                             top_p=0.9, seed=seed)]
        if len(runs) == 1:            # a co-tenant the first run lacked
            gids.append(engine.start(prompt[::-1].copy(), 9))
        toks, err = _drain(engine, gids[0])
        assert err is None
        runs.append(toks)
        for g in gids[1:]:
            _drain(engine, g)
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(0 <= t < VOCAB for t in runs[0])


def test_rng_skip_resumes_a_sampled_stream(engine):
    """A stream resumed after 2 delivered tokens (prompt grown by them,
    ``rng_skip=2``) continues as the uninterrupted stream."""
    prompt = np.random.RandomState(8).randint(0, VOCAB, (5,)).astype(
        np.int32)
    kw = dict(temperature=1.0, seed=5)
    full, err = _drain(engine, engine.start(prompt, 6, **kw))
    assert err is None
    grown = np.concatenate([prompt, np.asarray(full[:2], np.int32)])
    rest, err = _drain(engine, engine.start(grown, 4, rng_skip=2, **kw))
    assert err is None and rest == full[2:]
    g = advance_generator(torch.Generator(), 5, 3)
    assert g.initial_seed() == stream_seed(5, 3)


def test_engine_requires_slots_flag(pair):
    assert int(flag("gen_slots")) == 0
    with pytest.raises(ValueError, match="gen_slots"):
        GenerationEngine(pair[1])
    set_flags({"gen_slots": 2})
    try:
        eng = GenerationEngine(pair[1], max_len=32)
        assert eng.slots == 2
        eng.close()
    finally:
        set_flags({"gen_slots": 0})


def test_start_validates_capacity(engine):
    with pytest.raises(ValueError, match="capacity"):
        engine.start(np.arange(10, dtype=np.int32), 30)   # 40 > 32
    with pytest.raises(ValueError, match="empty"):
        engine.start(np.zeros((0,), np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.start(np.arange(3, dtype=np.int32), 0)


@pytest.mark.parametrize("kw,item", [
    (dict(spec_k=2), "A2c"), (dict(async_depth=1), "A2c"),
    (dict(draft_model=object()), "A2c"), (dict(kv_store=True), "A2d"),
    (dict(role="decode"), "A2d"), (dict(sched=True), "A2d"),
    (dict(ledger=True), "A2d"), (dict(rebuilds=1), "A2d"),
    (dict(quarantine_after=2), "A2d"), (dict(watchdog_s=1.0), "A2d"),
    (dict(mesh_tp=2), "A6")])
def test_unported_constructor_arguments_raise(pair, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        GenerationEngine(pair[1], slots=1, **kw)


def test_prefill_fault_breaks_the_engine_loudly(pair):
    """A trap in the loop (the ``engine.prefill`` fault site) fails the
    generation with the error and refuses new starts."""
    with GenerationEngine(pair[1], slots=1, max_len=16) as eng:
        with fault.inject_faults({"engine.prefill": 1.0}):
            toks, err = _drain(eng, eng.start(np.arange(3,
                                                        dtype=np.int32), 2))
        assert toks == [] and "InjectedFault" in err
        assert eng.stats()["broken"]
        with pytest.raises(RuntimeError, match="broken"):
            eng.start(np.arange(3, dtype=np.int32), 2)


def test_cpu_engine_launches_no_kernel(pair):
    _support.reset_launches()
    with GenerationEngine(pair[1], slots=2, max_len=16) as eng:
        _drain(eng, eng.start(np.arange(4, dtype=np.int32), 3))
    assert all(n == 0 for n in _support.LAUNCHES.values())


# ------------------------------------------------------------ paged mode

def test_paged_interleaved_matches_solo_generate(pair, paged_engine):
    jm, _ = pair
    prompts = np.random.RandomState(21).randint(0, VOCAB, (8, 6)).astype(
        np.int32)
    out = _concurrent(paged_engine, prompts, 5)
    for i in range(8):
        toks, err = out[i]
        assert err is None
        np.testing.assert_array_equal(toks, _solo(jm, prompts[i], 5),
                                      err_msg=f"request {i}")
    st = paged_engine.stats()
    assert st["active"] == 0 and st["queued"] == 0
    assert st["pages_free"] == st["pages"]     # 11 tokens: nothing cached


def test_paged_prefix_sharing_matches_solo(pair, paged_engine):
    """Streams sharing a 17-token prefix (2 full pages) map them onto the
    same physical pages; each stream still equals solo generate."""
    jm, _ = pair
    rs = np.random.RandomState(22)
    prefix = rs.randint(0, VOCAB, (17,)).astype(np.int32)
    hits0 = get_stat("gen/prefix_hits")
    saved0 = get_stat("gen/prefix_tokens_saved")
    for t in range(3):
        p = np.concatenate([prefix, rs.randint(0, VOCAB, (3,)).astype(
            np.int32)])
        toks, err = _drain(paged_engine, paged_engine.start(p, 4))
        assert err is None
        np.testing.assert_array_equal(toks, _solo(jm, p, 4),
                                      err_msg=f"stream {t}")
    assert get_stat("gen/prefix_hits") == hits0 + 2
    assert get_stat("gen/prefix_tokens_saved") == saved0 + 2 * 2 * 8
    st = paged_engine.stats()
    assert st["prefix_entries"] >= 2
    assert st["pages_free"] == st["pages"] - st["prefix_entries"]
    paged_engine.clear_prefix_cache()
    assert paged_engine.stats()["pages_free"] == st["pages"]


def test_paged_long_prompt_chunked_prefill_matches_solo(pair, paged_engine):
    """A 26-token prompt prefills in 3-token chunks over several pages
    (each chunk after the first runs the chunk arm at index > 0) and
    still equals solo generate."""
    jm, _ = pair
    p = np.random.RandomState(23).randint(0, VOCAB, (26,)).astype(np.int32)
    h0 = (get_histogram("gen/prefill_chunk_s") or {}).get("count", 0)
    toks, err = _drain(paged_engine, paged_engine.start(p, 5))
    assert err is None
    np.testing.assert_array_equal(toks, _solo(jm, p, 5))
    assert get_histogram("gen/prefill_chunk_s")["count"] - h0 >= 9
    paged_engine.clear_prefix_cache()


def test_paged_sampled_deterministic_per_seed(paged_engine):
    prompt = np.random.RandomState(24).randint(0, VOCAB, (9,)).astype(
        np.int32)
    runs = [_drain(paged_engine, paged_engine.start(
        prompt, 6, temperature=0.8, top_k=7, top_p=0.9, seed=42))[0]
        for _ in range(2)]
    assert runs[0] == runs[1]
    paged_engine.clear_prefix_cache()


def test_paged_cancel_mid_chunked_prefill_frees_all_pages(pair):
    with GenerationEngine(pair[1], slots=2, max_len=32, paged=True,
                          page_tokens=4, prefill_chunk=2,
                          step_wait_s=0.02) as eng:
        p = np.random.RandomState(31).randint(0, VOCAB, (20,)).astype(
            np.int32)
        gid = eng.start(p, 8)
        assert _wait(lambda: eng.stats()["active"] == 1)
        assert eng.cancel(gid)
        assert _wait(lambda: eng.stats()["active"] == 0)
        eng.clear_prefix_cache()
        st = eng.stats()
        assert st["pages_free"] == st["pages"]


def test_paged_prefix_eviction_under_pool_pressure(pair):
    """A pool-starved admit LRU-evicts cached prefix pages instead of
    stalling (``tests/test_paged_cache.py:300``)."""
    jm, tm = pair
    rs = np.random.RandomState(33)
    with GenerationEngine(tm, slots=2, max_len=32, queue_max=2, paged=True,
                          page_tokens=4, pages=8, prefix_cache=True) as eng:
        a = rs.randint(0, VOCAB, (8,)).astype(np.int32)
        assert _drain(eng, eng.start(a, 4))[1] is None
        assert eng.stats()["prefix_entries"] == 2
        assert eng.stats()["pages_free"] == 6
        ev0 = get_stat("gen/prefix_evictions")
        b = rs.randint(0, VOCAB, (20,)).astype(np.int32)
        toks, err = _drain(eng, eng.start(b, 8))
        assert err is None
        np.testing.assert_array_equal(toks, _solo(jm, b, 8))
        assert get_stat("gen/prefix_evictions") >= ev0 + 1


def test_paged_start_rejects_request_larger_than_pool(pair):
    with GenerationEngine(pair[1], slots=2, max_len=32, paged=True,
                          page_tokens=4, pages=4) as eng:
        with pytest.raises(ValueError, match="pages"):
            eng.start(np.arange(10, dtype=np.int32), 16)   # needs 7 > 4
        toks, err = _drain(eng, eng.start(np.arange(6, dtype=np.int32), 2))
        assert err is None and len(toks) == 2


def test_paged_int8_cache_matches_solo(pair):
    """The int8 pool (4 leaves) through the plain versions on the CPU:
    paged int8 decode equals JAX solo int8 generate."""
    import jax.numpy as jnp

    jm, tm = pair
    rs = np.random.RandomState(35)
    with GenerationEngine(tm, slots=2, max_len=32, paged=True,
                          page_tokens=8, prefill_chunk=5,
                          cache_dtype=torch.int8) as eng:
        assert len(eng._cache) == 4
        for n in (5, 11):
            p = rs.randint(0, VOCAB, (n,)).astype(np.int32)
            toks, err = _drain(eng, eng.start(p, 6))
            assert err is None
            np.testing.assert_array_equal(
                toks, _solo(jm, p, 6, cache_dtype=jnp.int8))


def test_page_pool_and_prefix_cache_books():
    """The host allocator's refcounts and the radix cache's leaf-first
    LRU eviction (``tests/test_paged_cache.py:59-124``)."""
    pool = _PagePool(4)
    a = pool.alloc(2)
    assert a == [1, 2] and pool.free_count == 2
    pool.retain(a[0])
    pool.release(a[0])
    assert pool.refcount(a[0]) == 1
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(3)
    cache = _PrefixCache(2)
    prompt = np.arange(5, dtype=np.int32)
    cache.insert(prompt, a, pool)
    assert len(cache) == 2 and pool.refcount(a[0]) == 2
    hit = cache.match(prompt, pool)
    assert hit == a
    for pid in hit + a:
        pool.release(pid)
    assert cache.evict(1, pool) == 1 and len(cache) == 1   # the leaf first
    assert cache.evict(5, pool) == 1 and pool.free_count == 4
    with pytest.raises(AssertionError, match="underflow"):
        pool.release(1)
