"""The port's generation server (``paddle_tpu_torch.io.serving``) against
the JAX package's, on the CPU.

A small Llama (V = 96, E = 32, 2 layers, fp32) is built in the JAX
package from a key and carried into the port by ``bridge.py``. The JAX
``InferenceServer`` serves it from a paged int8 JAX engine; the port's
server serves the bridged copy from a paged int8 port engine (8-token
pages, 5-token prefill chunks, the plain versions on the CPU). Greedy
streams from the port's server, read by the port's and by the JAX
package's ``InferenceClient``, equal the JAX server's token for token;
then six concurrent clients, cancel on iterator close, the poll TTL's
typed ``GenerationExpired`` across the wire, the ``health`` op with the
page pool and the ``deep`` canary, admin gating, and the surface that is
not ported answering errors that name its ROADMAP item.

Servers bind ``127.0.0.1:0``, every client has a timeout, every stream
is bounded by its ``max_new_tokens`` and every server is stopped by its
fixture.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io import serving as jax_serving
from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import engine as jax_engine

from paddle_tpu_torch import bridge
from paddle_tpu_torch.core.wire import WireShedError
from paddle_tpu_torch.io import InferenceClient, InferenceServer
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import GenerationEngine, GenerationExpired

pytestmark = pytest.mark.port

VOCAB = 96
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
           num_kv_heads=2, max_seq_len=64)
ENGINE = dict(slots=3, max_len=48, paged=True, page_tokens=8,
              prefill_chunk=5)
PROMPTS = [np.random.RandomState(i).randint(0, VOCAB, (n,)).astype(np.int32)
           for i, n in enumerate((5, 11, 17, 3, 23, 9))]
NEW = 8


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(JaxConfig.tiny(**CFG), key=jax.random.PRNGKey(7))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


@pytest.fixture(scope="module")
def jax_server(pair):
    srv = jax_serving.InferenceServer().start()
    srv.add_generator("llm", pair[0], cache_dtype=jnp.int8, **ENGINE)
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def port_server(pair):
    srv = InferenceServer().start()
    srv.add_generator("llm", pair[1], cache_dtype=torch.int8, **ENGINE)
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def reference(jax_server):
    """The JAX server's greedy streams of PROMPTS."""
    with jax_serving.InferenceClient(jax_server.endpoint,
                                     timeout=60.0) as c:
        return [list(c.generate("llm", p, NEW)) for p in PROMPTS]


CLIENTS = {"port": InferenceClient, "jax": jax_serving.InferenceClient}


@pytest.mark.parametrize("client", ["port", "jax"])
def test_greedy_streams_equal_the_jax_server(port_server, reference,
                                             client):
    """The paged int8 port engine behind the port's server: every greedy
    stream equals the JAX server's, read by either package's client."""
    with CLIENTS[client](port_server.endpoint, timeout=60.0) as c:
        got = [list(c.generate("llm", p, NEW)) for p in PROMPTS]
    assert got == reference


def test_port_client_streams_from_the_jax_server(jax_server, reference):
    with InferenceClient(jax_server.endpoint, timeout=60.0) as c:
        assert list(c.generate("llm", PROMPTS[1], NEW)) == reference[1]
        h = c.health()
    assert h["generators"]["llm"]["pages"] == 18


def test_six_concurrent_clients(port_server, reference):
    """Six clients, each its own connection and thread, through 3 slots:
    late admits and co-tenants leave every stream the JAX server's."""
    out, errors = {}, []

    def worker(i):
        try:
            with InferenceClient(port_server.endpoint, timeout=60.0) as c:
                out[i] = list(c.generate("llm", PROMPTS[i], NEW))
        except Exception as e:                 # noqa: BLE001 - collected
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors[:2]
    assert [out[i] for i in range(6)] == reference


def test_cancel_on_iterator_close(port_server):
    """Closing a stream early cancels it on the server: the slot and its
    pages come back now, not at the poll TTL."""
    eng = port_server._generator("llm")
    before = set(eng._gens)
    with InferenceClient(port_server.endpoint, timeout=60.0) as c:
        it = c.generate("llm", PROMPTS[4], 20)
        assert len([next(it), next(it)]) == 2
        (gid,) = set(eng._gens) - before
        it.close()
        # a cancel forgets the generation
        with pytest.raises(RuntimeError, match="unknown generation"):
            c.generate_poll("llm", gid)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and eng.stats()["active"]:
        time.sleep(0.02)
    st = eng.stats()
    assert st["active"] == 0 and st["undelivered"] == 0
    assert st["pages_free"] + st["prefix_entries"] == st["pages"]


@pytest.mark.parametrize("client", ["port", "jax"])
def test_generation_expired_across_the_wire(pair, client):
    """A generation reaped by the poll TTL answers the typed
    ``GenerationExpired`` of the client's package, not an unknown id."""
    expired = {"port": GenerationExpired,
               "jax": jax_engine.GenerationExpired}[client]
    srv = InferenceServer().start()
    try:
        srv.add_generator("short", pair[1], slots=1, max_len=48,
                          ttl_s=0.2, step_wait_s=0.05)
        with CLIENTS[client](srv.endpoint, timeout=30.0) as c:
            gid = c.generate_start("short", PROMPTS[0], 30)
            eng = srv._generator("short")
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and gid not in eng._expired:
                time.sleep(0.05)
            with pytest.raises(expired, match="expired"):
                c.generate_poll("short", gid)
            with pytest.raises(RuntimeError, match="unknown generation"):
                c.generate_poll("short", "nope")
    finally:
        srv.stop()


def test_health_ships_pages_and_the_deep_canary(port_server):
    with InferenceClient(port_server.endpoint, timeout=30.0) as c:
        list(c.generate("llm", PROMPTS[2], 3))
        h = c.health()
        deep = c.health(deep=True, stats=False)
    g = h["generators"]["llm"]
    assert g["paged"] and g["pages"] == 18 and g["page_tokens"] == 8
    assert 0 < g["pages_free"] <= g["pages"]
    assert g["pages_free"] + g["prefix_entries"] == g["pages"]
    # tokens a batched step emits over its slots (the JAX engine's count)
    assert 1.0 <= g["tokens_per_step"] <= ENGINE["slots"]
    pool = port_server._generator("llm")._cache
    assert g["device"] == {
        "platform": "cpu", "devices": 1, "mesh": None,
        "kv_bytes": sum(t.numel() * t.element_size() for t in pool),
        "kv_bytes_per_device": sum(t.numel() * t.element_size()
                                   for t in pool)}
    assert h["models"] == {} and "engine" not in g
    canary = deep["generators"]["llm"]["engine"]
    assert canary["ok"] and not canary["busy"] and canary["error"] is None
    assert deep["stats"] == {}


def test_health_keys_match_the_jax_server(port_server, jax_server):
    """Every key the JAX server's health op ships per generator that the
    port's engine carries (the rest are speculation, scheduler, KV-store
    and XLA-compile books: A2c, A2d)."""
    with InferenceClient(port_server.endpoint, timeout=30.0) as c:
        g = c.health()["generators"]["llm"]
    with jax_serving.InferenceClient(jax_server.endpoint,
                                     timeout=30.0) as c:
        jg = c.health()["generators"]["llm"]
    missing = set(jg) - set(g) - {"stuck", "rebuilds", "quarantined",
                                  "compiles", "recompiles",
                                  "recompile_storm", "device_pt",
                                  "async_depth", "pending_steps"}
    assert not missing
    assert set(g["device"]) == set(jg["device"])


def test_full_engine_sheds_with_a_retry_hint(pair):
    srv = InferenceServer().start()
    try:
        srv.add_generator("one", pair[1], slots=1, max_len=48,
                          queue_max=1, step_wait_s=0.05)
        with InferenceClient(srv.endpoint, timeout=30.0, retries=0) as c:
            first = c.generate_start("one", PROMPTS[0], 20)
            second = c.generate_start("one", PROMPTS[1], 20)
            with pytest.raises(WireShedError, match="engine full"):
                c.generate_start("one", PROMPTS[2], 20)
            for gid in (first, second):
                assert c.generate_cancel("one", gid) is True
    finally:
        srv.stop()


def test_sampled_streams_repeat_per_seed(port_server):
    with InferenceClient(port_server.endpoint, timeout=30.0) as c:
        a, b = (list(c.generate("llm", PROMPTS[1], NEW, temperature=0.8,
                                top_p=0.9, seed=11)) for _ in range(2))
        other = list(c.generate("llm", PROMPTS[1], NEW, temperature=0.8,
                                top_p=0.9, seed=12))
    assert a == b and len(a) == NEW and other != a


def test_admin_ops_gated(pair):
    srv = InferenceServer(admin_ops=False).start()
    try:
        with InferenceClient(srv.endpoint, timeout=10.0) as c:
            for call in (lambda: c.load_model("m", "/nowhere"),
                         lambda: c.unload_model("m"),
                         lambda: c._request("sched_quotas", {})):
                with pytest.raises(RuntimeError, match="admin op"):
                    call()
            c.stop_server()                       # refused: still serving
            assert c.health()["status"] == "ok"
            assert c.list_models() == {}
    finally:
        srv.stop()
    assert InferenceServer(host="127.0.0.1")._admin_ops
    exposed = InferenceServer(host="0.0.0.0")
    assert not exposed._admin_ops
    exposed.stop()


def test_stop_op_drains_and_closes_the_engines(pair):
    srv = InferenceServer().start()
    srv.add_generator("g", pair[1], slots=1, max_len=32)
    eng = srv._generator("g")
    with InferenceClient(srv.endpoint, timeout=10.0) as c:
        assert len(list(c.generate("g", PROMPTS[0], 3))) == 3
        c.stop_server()
    assert srv.stopped.wait(10.0)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.start(PROMPTS[0], 2)


@pytest.mark.parametrize("op,item", [
    ("infer", "A7"), ("load_model", "A7"), ("unload_model", "A7"),
    ("kv_put", "A2d"), ("kv_get", "A2d"), ("kv_probe", "A2d"),
    ("sched_quotas", "A2d")])
def test_unported_ops_name_their_item(port_server, op, item):
    calls = {"infer": lambda c: c.infer("m", np.zeros(3, np.float32)),
             "load_model": lambda c: c.load_model("m", "/x"),
             "unload_model": lambda c: c.unload_model("m")}
    with InferenceClient(port_server.endpoint, timeout=10.0,
                         retries=0) as c:
        with pytest.raises(RuntimeError,
                           match=f"NotImplementedError.*ROADMAP {item}"):
            calls.get(op, lambda c: c._request(op, {"key": "k"}))(c)
        assert c.health()["status"] == "ok"


def test_unported_server_surface_raises(pair):
    with pytest.raises(NotImplementedError, match="A7"):
        InferenceServer(models={"m": "/x"})
    srv = InferenceServer()
    with pytest.raises(NotImplementedError, match="A7"):
        srv.add_model("m", object())
    with pytest.raises(NotImplementedError, match="A7"):
        srv.unload_model("m")
    srv.stop()


def test_add_generator_takes_an_engine_and_replaces(pair):
    srv = InferenceServer()
    first = GenerationEngine(pair[1], slots=1, max_len=16)
    srv.add_generator("g", first)
    assert srv._generator("g") is first
    srv.add_generator("g", pair[1], slots=1, max_len=16)
    assert srv._generator("g") is not first
    with pytest.raises(RuntimeError, match="stopped"):
        first.start(PROMPTS[0], 2)                # the old one closed
    with pytest.raises(KeyError, match="no generator"):
        srv._generator("h")
    srv.stop()
