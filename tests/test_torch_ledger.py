"""The port's request ledger (``paddle_tpu_torch.serving.ledger``) against
``paddle_tpu/serving/ledger.py``, and its books in the port's engine, on
the CPU.

The three books get the same stamps in both packages (a fake generation
record, a fake clock) and must give the same records, tenant books and
goodput buckets. Then the engine: with the ledger on, every generation's
phases partition its end-to-end latency (residual below 1e-6), the
goodput buckets sum to 100% of the loop's wall clock, tenants are booked,
each retire path finalizes once under its outcome, and ``ledger_dump``
crosses the wire to the port's and the JAX package's clients. With the
ledger off the engine carries no books.
"""

import time
import types

import numpy as np
import pytest

from paddle_tpu.io import serving as jax_serving
from paddle_tpu.serving import ledger as jax_ledger

from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.core.monitor import get_histogram, reset_stats
from paddle_tpu_torch.io import InferenceClient, InferenceServer
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.serving import ledger as port_ledger

pytestmark = pytest.mark.port

CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
           num_kv_heads=2, max_seq_len=64)
PROMPT = np.arange(1, 10, dtype=np.int32)


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = get_flags(["gen_ledger", "gen_ledger_records"])
    yield
    set_flags(saved)


def _gen(created=10.0, admitted=0.0, first=0.0, done=0.0, tenant="acme",
         rng_skip=0, tokens=5, chip_s=0.25, booked=0.0):
    """A generation record as both ledgers read it."""
    return types.SimpleNamespace(
        gen_id="g1", tenant=tenant, created=created, admitted_ts=admitted,
        first_tok_ts=first, done_ts=done, prompt=np.zeros(7, np.int32),
        tokens=list(range(tokens)), chip_s=chip_s, rng_skip=rng_skip,
        spec_proposed=0, spec_accepted=0, queue_booked=booked)


STAMPS = {
    "whole": dict(admitted=10.5, first=11.0, done=12.5),
    "never admitted": dict(),
    "no first token": dict(admitted=10.2),
    "clock jitter": dict(admitted=9.0, first=13.0, done=12.0),
    "resumed": dict(admitted=10.1, first=10.3, done=10.9, rng_skip=4),
    "untagged": dict(admitted=10.1, first=10.3, done=10.9, tenant=None),
}


@pytest.mark.parametrize("stamps", STAMPS.values(), ids=STAMPS)
def test_ledger_records_match_jax_on_the_same_stamps(stamps):
    """The same stamps give the same record and tenant book in both
    ledgers, and the phases sum to the end-to-end latency."""
    books = []
    for mod in (jax_ledger, port_ledger):
        led = mod.RequestLedger(4)
        g = _gen(**stamps)
        led.book_admission(g, now=10.4)
        rec = led.finalize(g, "complete", now=13.0)
        books.append((rec, led.records(), led.tenants()))
    assert books[0] == books[1]
    rec = books[1][0]
    assert abs(sum(rec["phases"].values()) - rec["e2e_s"]) < 1e-12
    assert all(v >= 0 for v in rec["phases"].values())
    assert tuple(rec["phases"]) == port_ledger.PHASES


def test_ledger_ring_and_limit_match_jax():
    out = []
    for mod in (jax_ledger, port_ledger):
        led = mod.RequestLedger(3)
        for i in range(5):
            g = _gen(admitted=10.1, first=10.2 + i, done=15.0)
            g.gen_id = f"g{i}"
            led.finalize(g, "complete", now=16.0)
        out.append(([r["gen_id"] for r in led.records()],
                    [r["gen_id"] for r in led.records(2)], len(led)))
    assert out[0] == out[1] == (["g2", "g3", "g4"], ["g3", "g4"], 3)


def test_goodput_meter_matches_jax(monkeypatch):
    """The same notes and ticks on one fake clock: the same buckets, and
    they sum to the elapsed loop time (fractions to 1)."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    meters = [mod.GoodputMeter() for mod in (jax_ledger, port_ledger)]
    plan = [("prefill", 0.5, 0.7), ("decode", 0.2, 0.25),
            ("recompile", 1.0, 1.5), ("admission_idle", 0.3, 0.3),
            ("decode", 0.0, 0.1)]
    for bucket, dt, wall in plan:
        clock[0] += wall
        for m in meters:
            m.note(bucket, dt)
            m.tick("host_gather")
    snaps = [m.snapshot() for m in meters]
    assert snaps[0] == snaps[1]
    s = snaps[1]
    assert abs(s["total_s"] - sum(w for *_, w in plan)) < 1e-9
    assert abs(sum(s["fractions"].values()) - 1.0) < 1e-12
    assert s["goodput"] == pytest.approx(0.7 / 2.85)
    assert tuple(s["buckets"]) == port_ledger.GOODPUT_BUCKETS


def test_tenant_book_matches_jax():
    books = [mod.TenantBook() for mod in (jax_ledger, port_ledger)]
    for b in books:
        b.add("acme", tokens=3, chip_s=0.5, requests=1)
        b.add(None, queue_wait_s=0.25)
        b.add("acme", tokens=2, queue_wait_s=0.1)
    assert books[0].snapshot() == books[1].snapshot()
    assert set(books[1].snapshot()) == {"acme", "-"}


def _drain(eng, gid, timeout=60.0):
    toks = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = eng.poll(gid, start=len(toks), wait_s=0.5)
        toks += doc["tokens"]
        if doc["done"]:
            return toks, doc["error"]
    raise AssertionError("generation did not finish")


@pytest.mark.parametrize("paged", [False, True])
def test_engine_phases_partition_e2e(model, paged):
    """Every record's phases sum to its end-to-end latency, the goodput
    buckets to 100%, and the tenant book holds what was generated."""
    reset_stats("gen/")
    with GenerationEngine(model, slots=2, max_len=32, ledger=True,
                          paged=paged, page_tokens=8,
                          prefill_chunk=4) as eng:
        gids = [eng.start(PROMPT[:n], 5, tenant=t)
                for n, t in ((9, "acme"), (4, "zeta"), (6, None))]
        for gid in gids:
            toks, err = _drain(eng, gid)
            assert err is None and len(toks) == 5
        dump = eng.ledger_dump()
        st = eng.stats()
    recs = dump["records"]
    assert len(recs) == 3 and {r["outcome"] for r in recs} == {"complete"}
    for r in recs:
        assert abs(sum(r["phases"].values()) - r["e2e_s"]) < 1e-6
        assert r["phases"]["prefill_s"] > 0 and r["phases"]["decode_s"] > 0
        assert r["tokens"] == 5 and r["chip_s"] > 0
    assert {r["tenant"] for r in recs} == {"acme", "zeta", "-"}
    g = dump["goodput"]
    assert abs(sum(g["fractions"].values()) - 1.0) < 1e-9
    assert g["buckets"]["prefill"] > 0 and g["buckets"]["decode"] > 0
    assert 0 < g["goodput"] <= 1
    assert dump["tenants"]["acme"]["tokens"] == 5
    assert dump["tenants"]["acme"]["requests"] == 1
    assert st["tenants"] == dump["tenants"] and "goodput" in st
    assert get_histogram("gen/e2e_s")["count"] == 3
    assert get_histogram("gen/phase/decode_s")["count"] == 3


def test_every_retire_path_finalizes_once(model):
    with GenerationEngine(model, slots=1, max_len=32, ledger=True,
                          ttl_s=0.3, step_wait_s=0.02) as eng:
        cancelled = eng.start(PROMPT, 20)
        assert eng.poll(cancelled, wait_s=5.0)["tokens"]
        eng.cancel(cancelled)
        expired = eng.start(PROMPT, 20)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and expired not in eng._expired:
            time.sleep(0.05)
        done = eng.start(PROMPT[:3], 2)
        _drain(eng, done)
        eng.poll(done)                          # a second final poll
        stopped = eng.start(PROMPT, 20)
    outcomes = {r["gen_id"]: r["outcome"] for r in eng.ledger_dump()[
        "records"]}
    assert outcomes == {cancelled: "cancelled", expired: "expired",
                        done: "complete", stopped: "stopped"}


def test_ledger_flag_and_ring_capacity(model):
    set_flags({"gen_ledger": True, "gen_ledger_records": 2})
    with GenerationEngine(model, slots=2, max_len=32) as eng:
        for n in (3, 4, 5):
            _drain(eng, eng.start(PROMPT[:n], 2))
        assert len(eng.ledger_dump()["records"]) == 2
        assert len(eng.ledger_dump(limit=1)["records"]) == 1


def test_ledger_off_carries_no_books(model):
    with GenerationEngine(model, slots=1, max_len=32) as eng:
        _drain(eng, eng.start(PROMPT[:3], 2, tenant="acme"))
        st = eng.stats()
        assert eng.ledger_dump() is None and eng._goodput is None
    assert "goodput" not in st and "tenants" not in st


def test_shared_ledger_instance(model):
    """A shared ledger books both engines, from its first record on. The
    JAX engine tests the ledger's truth, and an empty RequestLedger has
    length 0, so there a fresh shared one leaves the books off (ROADMAP
    Queue C, reference looseness); the port tests its type."""
    import jax

    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.serving.engine import GenerationEngine as JaxEngine
    jm = JaxLlama(JaxConfig.tiny(**CFG), key=jax.random.PRNGKey(0))
    with JaxEngine(jm, slots=1, max_len=16,
                   ledger=jax_ledger.RequestLedger(8)) as jeng:
        assert jeng._ledger is None
    led = port_ledger.RequestLedger(8)
    with GenerationEngine(model, slots=1, max_len=32, ledger=led) as a, \
            GenerationEngine(model, slots=1, max_len=32, ledger=led) as b:
        for eng in (a, b):
            _drain(eng, eng.start(PROMPT[:3], 2, tenant="t"))
    assert len(led) == 2 and led.tenants()["t"]["requests"] == 2


@pytest.mark.parametrize("client", ["port", "jax"])
def test_ledger_dump_over_the_wire(model, client):
    cls = {"port": InferenceClient, "jax": jax_serving.InferenceClient}
    srv = InferenceServer().start()
    try:
        srv.add_generator("on", model, slots=2, max_len=32, ledger=True)
        srv.add_generator("off", model, slots=1, max_len=32)
        with cls[client](srv.endpoint, timeout=30.0) as c:
            assert len(list(c.generate("on", PROMPT, 4,
                                       tenant="acme"))) == 4
            list(c.generate("on", PROMPT[:4], 2))
            dump = c.ledger_dump()
            last = c.ledger_dump(limit=1)
            health = c.health()
    finally:
        srv.stop()
    assert set(dump["generators"]) == {"on"}
    assert dump["infer_tenants"] is None
    recs = dump["generators"]["on"]["records"]
    assert [r["tenant"] for r in recs] == ["acme", "-"]
    assert len(last["generators"]["on"]["records"]) == 1
    on = dump["generators"]["on"]
    assert on["tenants"]["acme"]["tokens"] == 4
    assert abs(sum(on["goodput"]["fractions"].values()) - 1.0) < 1e-9
    assert "tenants" in health["generators"]["on"]
    assert "tenants" not in health["generators"]["off"]
