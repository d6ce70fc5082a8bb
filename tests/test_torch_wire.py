"""The port's frame protocol (``paddle_tpu_torch.core.wire``) against the
JAX package's (``paddle_tpu.core.wire``), on the CPU.

The frames must be the same bytes: ``send_frame`` of both packages over
a ``socket.socketpair()`` writes identical streams, and each package's
``recv_frame`` reads the other's. A JAX ``FrameClient`` talks to a port
``FrameService`` and a port client to a JAX service: echo, the shed frame
with its ``retry_after_s``, the connection cap, drain, ``HEALTH_OP`` and
``TRACE_OP``. Then the port's counterparts of the wire tests of
``tests/test_trace.py`` and ``tests/test_overload.py`` (the parameter
server, heter worker, file service and preemption handler they also
cover are not ported).

Servers bind ``127.0.0.1:0``; every client has a timeout and every wait
is bounded. The port's flags (server caps) and the JAX package's (client
backoff) are separate registries; fixtures put both back.
"""

import json
import socket
import threading
import time

import pytest

from paddle_tpu.core import flags as jax_flags
from paddle_tpu.core import trace as jax_trace
from paddle_tpu.core import wire as jwire

from paddle_tpu_torch.core import monitor, trace
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.core import wire as pwire

pytestmark = pytest.mark.port

_FLAGS = ["wire_max_inflight", "wire_max_conns", "wire_server_idle_s",
          "wire_drain_s", "wire_backoff_max_s", "trace", "trace_buffer"]
_JAX_FLAGS = ["wire_backoff_max_s", "trace", "trace_buffer"]
WIRES = {"port": pwire, "jax": jwire}


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = get_flags(_FLAGS)
    jsaved = jax_flags.get_flags(_JAX_FLAGS)
    yield
    set_flags(saved)
    jax_flags.set_flags(jsaved)
    trace.clear()
    jax_trace.clear()


def _echo_service(wire):
    class _Echo(wire.FrameService):
        op_names = {1: "echo"}

        def _dispatch(self, sock, op, header, payload):
            wire.send_frame(sock, 0, {"echo": header.get("x"),
                                      "nbytes": len(payload)}, payload)
            return True
    return _Echo


_PortEcho = _echo_service(pwire)
_JaxEcho = _echo_service(jwire)


class _Slow(pwire.FrameService):
    """Holds its in-flight slot for ``delay`` seconds per request."""

    def __init__(self, delay):
        self.delay = delay
        super().__init__()

    def _dispatch(self, sock, op, header, payload):
        time.sleep(self.delay)
        pwire.send_frame(sock, 0, {"x": header.get("x")})
        return True


class _ShedOnce(pwire.FrameService):
    """A shed frame for the first request, then service."""

    def __init__(self):
        self.seen = 0
        super().__init__()

    def _dispatch(self, sock, op, header, payload):
        self.seen += 1
        if self.seen == 1:
            pwire.send_frame(sock, pwire.CODE_SHED,
                             {"error": "overloaded", "retry_after_s": 0.01})
        else:
            pwire.send_frame(sock, 0, {"ok": True})
        return True


class _ShedAlways(pwire.FrameService):
    def _dispatch(self, sock, op, header, payload):
        pwire.send_frame(sock, pwire.CODE_SHED,
                         {"error": "overloaded", "retry_after_s": 0.0})
        return True


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# ------------------------------------------------------------ the frames

def _read_all(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk
        buf += chunk
    return buf


FRAMES = [
    (0, {}, b""),
    (5, {"model": "llama", "prompt": [1, 2, 3], "max_new_tokens": 4,
         "temperature": 0.0, "top_k": 0, "top_p": 1.0, "seed": 0}, b""),
    (2, {"error": "InferenceServer overloaded", "retry_after_s": 0.0375},
     b""),
    (-1, {"clear": True, "tr": "00ff", "sp": "ab12", "u": "héllo ∑"},
     b""),
    (1, {"inputs": [{"shape": [3, 5], "dtype": "float32"}],
         "nbytes": 60}, bytes(range(60))),
    (9, {"nbytes": 1 << 20}, b"\x07" * (1 << 20)),
]


@pytest.mark.parametrize("code,header,payload", FRAMES,
                         ids=["empty", "start", "shed", "trace", "infer",
                              "1MiB"])
def test_frame_bytes_equal_jax(code, header, payload):
    """Both packages' ``send_frame`` write the same bytes."""
    streams = []
    for wire in (jwire, pwire):
        a, b = socket.socketpair()
        b.settimeout(10.0)
        got = {}
        reader = threading.Thread(target=lambda: got.setdefault(
            "bytes", _read_all(b, 8 + len(json.dumps(header).encode())
                               + len(payload))))
        reader.start()
        wire.send_frame(a, code, header, payload)
        reader.join(timeout=10)
        streams.append(got["bytes"])
        a.close()
        b.close()
    assert streams[0] == streams[1]


@pytest.mark.parametrize("sender,receiver", [("jax", "port"),
                                             ("port", "jax")])
@pytest.mark.parametrize("code,header,payload", FRAMES[1:5],
                         ids=["start", "shed", "trace", "infer"])
def test_recv_frame_reads_the_other_package(sender, receiver, code,
                                            header, payload):
    a, b = socket.socketpair()
    b.settimeout(10.0)
    WIRES[sender].send_frame(a, code, header, payload)
    got = WIRES[receiver].recv_frame(b)
    assert got == (code, header, payload)
    a.close()
    b.close()


@pytest.mark.parametrize("hlen", [-1, pwire.MAX_HEADER_BYTES + 1])
def test_recv_frame_bounds_the_header(hlen):
    a, b = socket.socketpair()
    b.settimeout(10.0)
    a.sendall(jwire.struct.pack("<ii", 0, hlen))
    with pytest.raises(ConnectionError, match="out of bounds"):
        pwire.recv_frame(b)
    a.close()
    b.close()


def test_recv_frame_bounds_the_payload():
    a, b = socket.socketpair()
    b.settimeout(10.0)
    pwire.send_frame(a, 1, {"nbytes": 64})
    with pytest.raises(ConnectionError, match="payload length"):
        pwire.recv_frame(b, max_payload=32)
    a.close()
    b.close()


# ------------------------------------------------- across the packages

@pytest.mark.parametrize("client,server", [("jax", "port"),
                                           ("port", "jax")])
def test_echo_across_packages(client, server):
    srv = {"port": _PortEcho, "jax": _JaxEcho}[server]().start()
    with WIRES[client].FrameClient(srv.endpoint, {"echo": 1},
                                   timeout=5.0) as c:
        h, p = c._request("echo", {"x": [1, "two"], "nbytes": 5}, b"abcde")
        assert h["echo"] == [1, "two"] and p == b"abcde"
        h = c.health()
        assert h["status"] == "ok" and h["conns"] >= 1
        assert h["service"] == "_Echo" and h["endpoint"] == srv.endpoint
        assert c.trace_dump() == {"enabled": False, "spans": [],
                                  "service": "_Echo",
                                  "endpoint": srv.endpoint}
    srv.stop()


def test_jax_client_retries_a_port_shed_frame():
    """The port's shed frame is the JAX client's retryable status: a
    non-idempotent op is retried after ``retry_after_s``."""
    srv = _ShedOnce().start()
    with jwire.FrameClient(srv.endpoint, {"push": 1}, timeout=5.0,
                           retries=2) as c:
        assert c._request("push", {})[0]["ok"] is True
    assert srv.seen == 2
    srv.stop()


def test_port_client_retries_a_jax_shed_frame():
    class _JaxShedOnce(jwire.FrameService):
        seen = 0

        def _dispatch(self, sock, op, header, payload):
            type(self).seen += 1
            code = jwire.CODE_SHED if self.seen == 1 else 0
            jwire.send_frame(sock, code, {"retry_after_s": 0.01,
                                          "error": "x", "ok": code == 0})
            return True

    srv = _JaxShedOnce().start()
    with pwire.FrameClient(srv.endpoint, {"push": 1}, timeout=5.0,
                           retries=2) as c:
        assert c._request("push", {})[0]["ok"] is True
    assert _JaxShedOnce.seen == 2
    srv.stop()


@pytest.mark.parametrize("client", ["jax", "port"])
def test_inflight_cap_sheds_with_retry_after(client):
    """A port service at its in-flight cap sheds with code 2 and a
    jittered ``retry_after_s``; the health op is still answered."""
    srv = _Slow(0.5).start()
    set_flags({"wire_max_inflight": 1})
    holder = pwire.FrameClient(srv.endpoint, {"go": 1}, timeout=10.0)
    t = threading.Thread(target=lambda: holder._request("go", {}))
    t.start()
    try:
        assert _wait(lambda: srv.health()["inflight"] == 1)
        s = socket.create_connection((srv.host, srv.port), timeout=5.0)
        WIRES[client].send_frame(s, 1, {})
        code, header, _ = WIRES[client].recv_frame(s)
        assert code == pwire.CODE_SHED == jwire.CODE_SHED
        assert 0.0 < header["retry_after_s"] < 0.1
        assert "overloaded" in header["error"]
        s.close()
        with WIRES[client].FrameClient(srv.endpoint, {}, timeout=5.0) as p:
            h = p.health()                 # never shed
        assert h["inflight"] == 1 and h["max_inflight"] == 1
    finally:
        t.join(timeout=10)
        holder.close()
        srv.stop()


@pytest.mark.parametrize("client", ["jax", "port"])
def test_connection_cap_across_packages(client):
    srv = _PortEcho().start()
    c1 = WIRES[client].FrameClient(srv.endpoint, {"e": 1}, timeout=5.0)
    assert c1._request("e", {"x": 1})[0]["echo"] == 1
    set_flags({"wire_max_conns": 1})
    c2 = WIRES[client].FrameClient(srv.endpoint, {"e": 1}, timeout=5.0,
                                   retries=0)
    with pytest.raises(RuntimeError, match="shed"):
        c2._request("e", {"x": 2})
    assert c1._request("e", {"x": 3})[0]["echo"] == 3
    c1.close()
    c2.close()
    srv.stop()


@pytest.mark.parametrize("client", ["jax", "port"])
def test_drain_across_packages(client):
    """A port service drains: the in-flight request of a client of either
    package completes, then the listener is gone."""
    srv = _Slow(0.4).start()
    c = WIRES[client].FrameClient(srv.endpoint, {"go": 1}, timeout=10.0,
                                  retries=0)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "h", c._request("go", {"x": 7})[0]))
    t.start()
    assert _wait(lambda: srv.health()["inflight"] == 1)
    assert srv.drain(5.0) is True
    t.join(timeout=10)
    assert out["h"]["x"] == 7
    with pytest.raises(OSError):
        WIRES[client].FrameClient(srv.endpoint, {}, timeout=1.0, retries=0)
    c.close()


def test_jax_client_trace_joins_port_server_span():
    """A traced JAX client's ``tr``/``sp`` header keys link the port
    server's span into the client's trace; the port's ``TRACE_OP``
    serves it."""
    jax_flags.set_flags({"trace_buffer": 256, "trace": True})
    set_flags({"trace_buffer": 256, "trace": True})
    srv = _PortEcho().start()
    with jwire.FrameClient(srv.endpoint, {"echo": 1}, service="jx",
                           timeout=5.0) as c:
        c._request("echo", {"x": 1})
        client = [s for s in jax_trace.get_spans()
                  if s["name"] == "wire/jx.echo"]
        assert _wait(lambda: any(s["name"] == "wire/_Echo.echo"
                                 for s in trace.get_spans()), 2.0)
        server = [s for s in trace.get_spans()
                  if s["name"] == "wire/_Echo.echo"]
        assert len(client) == 1 and len(server) == 1
        assert server[0]["trace_id"] == client[0]["trace_id"]
        assert server[0]["parent_id"] == client[0]["span_id"]
        dump = c.trace_dump()
        assert dump["enabled"] and dump["service"] == "_Echo"
        assert server[0]["span_id"] in {s["span_id"] for s in dump["spans"]}
    srv.stop()


# ---------------------------------- counterparts of tests/test_trace.py

def _tracing_on(capacity=4096):
    set_flags({"trace_buffer": capacity, "trace": True})


def test_wire_round_trip_joins_one_trace():
    """A traced round trip: a client span and a server span of one trace,
    the server's parent the client span; both latency histograms fill;
    ``trace_dump`` scrapes it. The server closes its span after the reply
    is sent (the JAX package's order), so the server span is waited for,
    at most 2 s."""
    _tracing_on()
    monitor.reset_stats("wire/")
    srv = _PortEcho().start()
    c = pwire.FrameClient(srv.endpoint, {"echo": 1}, service="test",
                          timeout=5.0)
    assert c._request("echo", {"x": 7})[0]["echo"] == 7
    assert _wait(lambda: any(s["name"] == "wire/_Echo.echo"
                             for s in trace.get_spans()), 2.0)
    spans = trace.get_spans()
    client = [s for s in spans if s["name"] == "wire/test.echo"]
    server = [s for s in spans if s["name"] == "wire/_Echo.echo"]
    assert len(client) == 1 and len(server) == 1
    assert client[0]["trace_id"] == server[0]["trace_id"]
    assert server[0]["parent_id"] == client[0]["span_id"]
    assert client[0]["tid"] != server[0]["tid"]
    hists = monitor.export_histograms("wire/")
    assert hists["wire/op_latency_s/test.echo"]["count"] == 1
    assert hists["wire/server_latency_s/_Echo.echo"]["count"] == 1
    dump = c.trace_dump()
    assert dump["enabled"] and dump["service"] == "_Echo"
    assert {s["span_id"] for s in dump["spans"]} >= {
        client[0]["span_id"], server[0]["span_id"]}
    c.close()
    srv.stop()


def test_untraced_client_headers_are_clean():
    captured = {}

    class _Capture(pwire.FrameService):
        def _dispatch(self, sock, op, header, payload):
            captured.update(header)
            pwire.send_frame(sock, 0, {})
            return True

    srv = _Capture().start()
    c = pwire.FrameClient(srv.endpoint, {"go": 1}, timeout=5.0)
    c._request("go", {"x": 1})
    assert "tr" not in captured and "sp" not in captured
    c.close()
    srv.stop()


def test_trace_dump_clear_drains_server_buffer():
    _tracing_on()
    srv = _PortEcho().start()
    c = pwire.FrameClient(srv.endpoint, {"echo": 1}, service="t",
                          timeout=5.0)
    c._request("echo", {})
    assert c.trace_dump(clear=True)["spans"]
    remaining = {s["name"] for s in c.trace_dump()["spans"]}
    assert "wire/t.echo" not in remaining
    c.close()
    srv.stop()


def test_disabled_tracing_is_a_shared_noop():
    assert not trace.enabled()
    s = trace.span("x", k=1)
    assert s is trace.server_span("y", "t", "p")
    assert trace.snapshot() == {"enabled": False, "spans": []}


def test_export_chrome_is_valid_json(tmp_path):
    _tracing_on()
    with trace.span("parent", step=1):
        with trace.span("child"):
            pass
    path = str(tmp_path / "trace.json")
    trace.export_chrome(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert len(events) == 2
    for e in events:
        assert e["ph"] == "X"
        assert set(e) >= {"name", "ts", "dur", "pid", "tid", "args"}
        assert e["args"]["trace_id"]
    child = next(e for e in events if e["name"] == "child")
    parent = next(e for e in events if e["name"] == "parent")
    assert child["args"]["parent_id"] == parent["args"]["span_id"]
    assert parent["args"]["step"] == 1
    assert trace.to_chrome_events(trace.get_spans(), pid=3,
                                  pid_name="x")[0]["ph"] == "M"
    # the same events as the JAX package's exporter makes of these spans
    assert trace.to_chrome_events(trace.get_spans()) == \
        jax_trace.to_chrome_events(trace.get_spans())


def test_obs_dump_scrapes_port_services(tmp_path):
    """The repository's ``tools/obs_dump.py`` (a client of the JAX
    package) probes two port services and writes one merged Chrome trace
    with a pid per endpoint: the frames are the same."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "obs_dump", os.path.join(os.path.dirname(__file__), "..", "tools",
                                 "obs_dump.py"))
    obs_dump = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_dump)
    _tracing_on()
    a, b = _PortEcho().start(), _PortEcho().start()
    with pwire.FrameClient(a.endpoint, {"echo": 1}, timeout=5.0) as c:
        c._request("echo", {})
    out = str(tmp_path / "fleet.json")
    assert obs_dump.main([a.endpoint, b.endpoint, "-o", out,
                          "--stats-prefix", "wire/"]) == 0
    with open(out) as f:
        doc = json.load(f)
    assert {e["pid"] for e in doc["traceEvents"]} >= {1, 2}
    assert "process_name" in {e["name"] for e in doc["traceEvents"]}
    a.stop()
    b.stop()


def test_health_stats_prefix_filters_payload():
    monitor.reset_stats()
    monitor.stat_add("wire/x", 1)
    monitor.stat_add("ckpt/y", 2)
    srv = _PortEcho().start()
    with pwire.FrameClient(srv.endpoint, {}, timeout=5.0) as probe:
        full = probe.health()
        wire_only = probe.health(stats_prefix="wire/")
        none = probe.health(stats_prefix="no-such-prefix/")
        bare = probe.health(stats=False)
    assert "ckpt/y" in full["stats"]
    assert "wire/x" in wire_only["stats"]
    assert not any(not k.startswith("wire/") for k in wire_only["stats"])
    assert none["stats"] == {} and bare["stats"] == {}
    assert wire_only["status"] == "ok" and "inflight" in wire_only
    srv.stop()


# ------------------------------- counterparts of tests/test_overload.py

def test_shed_under_load_then_all_recover():
    """cap 1 and a burst of 8 requests: some are shed with code 2, every
    client succeeds after its retries, both sides of the shed counted."""
    srv = _Slow(0.05).start()
    set_flags({"wire_max_inflight": 1, "wire_backoff_max_s": 0.2})
    monitor.reset_stats("wire/")
    results, errors = [], []
    gate = threading.Barrier(8)

    def worker(i):
        c = pwire.FrameClient(srv.endpoint, {"go": 1}, timeout=10.0,
                              retries=32)
        try:
            gate.wait()
            results.append(c._request("go", {"x": i})[0]["x"])
        except Exception as e:              # noqa: BLE001 - collected
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:2]
    assert sorted(results) == list(range(8))
    assert monitor.get_stat("wire/shed") >= 1
    assert monitor.get_stat("wire/shed_server") >= 1
    srv.stop()


def test_shed_retried_even_for_non_idempotent_ops():
    srv = _ShedOnce().start()
    monitor.reset_stats("wire/")
    c = pwire.FrameClient(srv.endpoint, {"push": 1}, service="test",
                          timeout=5.0, retries=2)
    assert c._request("push", {})[0]["ok"] is True
    assert monitor.get_stat("wire/shed") == 1
    assert monitor.get_stat("wire/retries") == 0
    c.close()
    srv.stop()


def test_shed_budget_exhaustion_surfaces_error():
    srv = _ShedAlways().start()
    c = pwire.FrameClient(srv.endpoint, {"push": 1}, service="test",
                          timeout=5.0, retries=1)
    with pytest.raises(pwire.WireShedError, match="shed .* after 2 attempt"):
        c._request("push", {})
    c.close()
    srv.stop()


def test_connection_cap_sheds_excess_connection():
    srv = _PortEcho().start()
    c1 = pwire.FrameClient(srv.endpoint, {"e": 1}, timeout=5.0)
    assert c1._request("e", {"x": 1})[0]["echo"] == 1
    set_flags({"wire_max_conns": 1})
    monitor.reset_stats("wire/")
    c2 = pwire.FrameClient(srv.endpoint, {"e": 1}, timeout=5.0, retries=0)
    with pytest.raises(RuntimeError, match="shed"):
        c2._request("e", {"x": 2})
    assert monitor.get_stat("wire/shed_conns") >= 1
    assert c1._request("e", {"x": 3})[0]["echo"] == 3
    c1.close()
    c2.close()
    srv.stop()


def test_health_served_by_every_port_service():
    from paddle_tpu_torch.io import InferenceServer
    for name, srv in {"_Echo": _PortEcho(),
                      "InferenceServer": InferenceServer()}.items():
        srv.start()
        with pwire.FrameClient(srv.endpoint, {}, service="probe",
                               timeout=5.0) as probe:
            h = probe.health()
        assert h["status"] == "ok" and h["service"] == name
        assert h["inflight"] == 0 and h["conns"] >= 1
        assert h["uptime_s"] >= 0.0 and isinstance(h["stats"], dict)
        srv.stop()


def test_health_never_shed_under_full_load():
    srv = _Slow(0.5).start()
    set_flags({"wire_max_inflight": 1})
    c = pwire.FrameClient(srv.endpoint, {"go": 1}, timeout=10.0, retries=0)
    t = threading.Thread(target=lambda: c._request("go", {}))
    t.start()
    try:
        assert _wait(lambda: srv.health()["inflight"] == 1)
        with pwire.FrameClient(srv.endpoint, {}, timeout=5.0) as probe:
            h = probe.health()
        assert h["inflight"] == 1 and h["max_inflight"] == 1
    finally:
        t.join(timeout=10)
        c.close()
        srv.stop()


def test_drain_completes_inflight_before_sever():
    srv = _Slow(0.4).start()
    c = pwire.FrameClient(srv.endpoint, {"go": 1}, timeout=10.0, retries=0)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "x", c._request("go", {"x": 3})[0]["x"]))
    t.start()
    assert _wait(lambda: srv.health()["inflight"] == 1)
    assert srv.drain(5.0) is True
    t.join(timeout=10)
    assert out["x"] == 3
    with pytest.raises(OSError):
        pwire.FrameClient(srv.endpoint, {}, timeout=1.0, retries=0)
    c.close()


def test_health_reports_draining_and_new_requests_shed():
    srv = _Slow(0.6).start()
    c = pwire.FrameClient(srv.endpoint, {"go": 1}, timeout=10.0, retries=0)
    probe = pwire.FrameClient(srv.endpoint, {"go": 1}, service="probe",
                              timeout=5.0, retries=0)
    assert probe.health()["status"] == "ok"
    t = threading.Thread(target=lambda: c._request("go", {}))
    t.start()
    assert _wait(lambda: srv.health()["inflight"] == 1)
    d = threading.Thread(target=srv.drain, args=(5.0,))
    d.start()
    saw_draining = saw_shed = False
    while d.is_alive():
        try:
            saw_draining |= probe.health()["status"] == "draining"
            if not saw_shed:
                try:
                    probe._request("go", {})
                except RuntimeError as e:
                    saw_shed = "shed" in str(e)
        except (ConnectionError, OSError):
            break
        time.sleep(0.02)
    d.join(timeout=10)
    t.join(timeout=10)
    assert saw_draining and saw_shed
    probe.close()
    c.close()


def test_idle_connection_reaped():
    set_flags({"wire_server_idle_s": 0.3})
    monitor.reset_stats("wire/")
    srv = _PortEcho().start()
    s = socket.create_connection((srv.host, srv.port))
    s.settimeout(5.0)
    t0 = time.monotonic()
    assert s.recv(1) == b""
    assert time.monotonic() - t0 < 4.0
    assert monitor.get_stat("wire/idle_closed") == 1
    s.close()
    srv.stop()


def test_late_connection_during_stop_is_closed_immediately():
    srv = _PortEcho().start()
    with srv._conns_lock:
        srv._stopping = True
    s = socket.create_connection((srv.host, srv.port))
    s.settimeout(5.0)
    assert s.recv(1) == b""
    with srv._conns_lock:
        assert not srv._conns
    s.close()
    srv.stop()


def test_wire_fault_sites_fail_a_request_like_a_dead_peer():
    """``wire.send`` and ``wire.recv`` (the sites ``FrameClient`` injects)
    fail a request as a dead connection does: an idempotent op is retried
    across a reconnect."""
    from paddle_tpu_torch.core import fault
    srv = _PortEcho().start()
    monitor.reset_stats("wire/")
    with pwire.FrameClient(srv.endpoint, {"echo": 1}, timeout=5.0,
                           retries=2, idempotent=("echo",)) as c:
        for site in ("wire.send", "wire.recv"):
            with fault.inject_faults({site: (1.0, 1)}):
                assert c._request("echo", {"x": 5})[0]["echo"] == 5
                assert fault.site_counts()[site] == (2, 1)
        with fault.inject_faults({"wire.send": 1.0}):
            with pytest.raises(ConnectionError, match="3 attempt"):
                c._request("echo", {"x": 5})
    assert monitor.get_stat("wire/retries") == 4
    assert not fault.enabled()
    srv.stop()


# ------------------------------------------------------------- monitor

def test_monitor_exports_match_jax():
    """``merge_histograms`` and ``hist_fraction_above`` of the port on the
    JAX registry's raw snapshots give the JAX package's numbers (shared
    bucket bounds)."""
    from paddle_tpu.core import monitor as jm
    vals = [1e-4 * 1.37 ** i for i in range(40)]
    jm.reset_stats("t/")
    monitor.reset_stats("t/")
    for i, v in enumerate(vals):
        jm.observe(f"t/h{i % 2}", v)
        monitor.observe(f"t/h{i % 2}", v)
    jdocs = jm.export_histograms("t/", raw=True)
    pdocs = monitor.export_histograms("t/", raw=True)
    assert pdocs == jdocs
    assert monitor.merge_histograms(list(pdocs.values()), raw=True) == \
        jm.merge_histograms(list(jdocs.values()), raw=True)
    for thr in (1e-4, 3.3e-3, 0.05, 1e3):
        for cons in (False, True):
            assert monitor.hist_fraction_above(pdocs["t/h0"], thr, cons) \
                == jm.hist_fraction_above(jdocs["t/h0"], thr, cons)
    monitor.stat_add("t/a", 2)
    assert monitor.export_stats("t/") == {"t/a": 2}
    monitor.reset_stats("t/")
    assert monitor.export_stats("t/") == {}
    assert monitor.export_histograms("t/") == {}
