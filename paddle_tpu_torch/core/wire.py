"""Length-prefixed binary frame protocol of the port's TCP services — the
port of ``paddle_tpu/core/wire.py``, byte for byte on the wire, so that a
client of either package talks to a server of the other.

One request frame

    [4B op][4B json_len][json header][raw payload]

and one response frame ``[4B status][4B json_len][json][raw payload]``
(``<ii``, little-endian int32; the header is ``json.dumps`` of a dict,
whose ``nbytes`` gives the payload's length). Buffers cross the wire raw,
no pickling, so a malformed frame cannot execute code; header and payload
lengths from a peer are bounded (``MAX_HEADER_BYTES``,
``MAX_PAYLOAD_BYTES``). A service still gates its mutating ops before it
is exposed beyond loopback (``io.serving.InferenceServer``'s
``admin_ops``).

:class:`FrameService` is the threaded server skeleton (admission control,
the shed frame, the connection cap, idle reaping, drain and stop, the
universal ``HEALTH_OP`` and ``TRACE_OP``, and the traced dispatch that
links its span to the client's through the ``tr``/``sp`` header keys);
:class:`FrameClient` the client (deadline, retries with backoff across a
reconnect, shed retries for every op, in-flight accounting,
:class:`WireShedError`). Host-side only: nothing here touches a device.
"""

from __future__ import annotations

import json
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Iterable

from paddle_tpu_torch.core import fault as _fault
from paddle_tpu_torch.core import trace as _trace
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.core.monitor import (export_histograms, export_stats,
                                           observe, stat_add)

__all__ = ["send_frame", "recv_frame", "FrameService", "FrameClient",
           "MAX_HEADER_BYTES", "MAX_PAYLOAD_BYTES", "CODE_SHED",
           "HEALTH_OP", "TRACE_OP", "WireShedError", "PRIORITY_HEADER"]


class WireShedError(RuntimeError):
    """A request exhausted its shed-retry budget: every attempt was
    turned away by the server's admission control (:data:`CODE_SHED`)
    before execution. Subclasses RuntimeError for compatibility; typed
    so routers can treat "this replica is overloaded" differently from
    "this request failed" — the request is safe to re-issue anywhere
    (it never ran)."""

# Response status codes. 0 = ok, 1 = error (request ran or was malformed).
# CODE_SHED rejections happen BEFORE execution (admission control, drain,
# connection cap), so clients may retry them for ANY op — including
# non-idempotent ones — honoring the header's ``retry_after_s`` hint.
CODE_SHED = 2

# Op number reserved by FrameService for the universal health probe;
# subclass op tables start at 1, so 0 never reaches ``_dispatch``.
HEALTH_OP = 0

# Reserved (negative: outside every subclass op table) for the span
# scrape — answered by FrameService itself and, like health, never shed,
# so tools/obs_dump.py can pull timelines off an overloaded service.
TRACE_OP = -1

# Request-header keys carrying the client span's trace context across the
# wire (kept short: they ride every traced request frame).
_TRACE_ID_KEY = "tr"
_TRACE_PARENT_KEY = "sp"

# Request-header key carrying the scheduling priority class (next to the
# tenant header "tn"): "interactive" / "batch" / "best_effort". Consulted
# by admission control only when a shed gate is installed (the JAX
# package's FLAGS_gen_sched scheduler installs one; the port's scheduler
# is ROADMAP A2d); inert metadata otherwise.
PRIORITY_HEADER = "pc"

# Hard caps on request frames arriving at a server. Header/payload lengths
# come from the (untrusted) peer; without a bound a single corrupt frame
# could demand an arbitrarily large allocation. Clients reading replies
# from a server they chose to connect to pass ``max_payload=None``.
MAX_HEADER_BYTES = 1 << 20   # 1 MiB of JSON is already absurd
MAX_PAYLOAD_BYTES = 1 << 31  # 2 GiB per request frame


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, code: int, header: dict[str, Any],
               payload: bytes = b"") -> None:
    hj = json.dumps(header).encode()
    prefix = struct.pack("<ii", code, len(hj)) + hj
    if not payload:
        sock.sendall(prefix)
        return
    # one gathered write: no concatenation copy of the (up to 2 GiB)
    # payload, and no Nagle write-write-read stall from a separate small
    # prefix segment (this protocol is strictly request-then-reply)
    buffers = [prefix, payload]
    while buffers:
        sent = sock.sendmsg(buffers)
        while buffers and sent >= len(buffers[0]):
            sent -= len(buffers[0])
            buffers.pop(0)
        if buffers and sent:
            buffers[0] = memoryview(buffers[0])[sent:]


def recv_frame(sock: socket.socket,
               max_payload: int | None = MAX_PAYLOAD_BYTES):
    code, hlen = struct.unpack("<ii", _recv_exact(sock, 8))
    if not 0 <= hlen <= MAX_HEADER_BYTES:
        raise ConnectionError(f"header length {hlen} out of bounds")
    header = json.loads(_recv_exact(sock, hlen)) if hlen else {}
    nbytes = int(header.get("nbytes", 0))
    if nbytes < 0 or (max_payload is not None and nbytes > max_payload):
        raise ConnectionError(f"payload length {nbytes} out of bounds")
    payload = _recv_exact(sock, nbytes)
    return code, header, payload


class FrameService:
    """Threaded TCP service skeleton over the frame protocol.

    One thread per connection (the reference RPC servers' thread-pool
    role), frames dispatched to ``_dispatch(sock, op, header, payload)
    -> bool`` (False closes the connection). Subclasses implement
    ``_dispatch``; ``start``/``stop`` manage the accept loop — shared so
    lifecycle fixes (e.g. shutdown() hanging when the loop never ran)
    exist in exactly one place.

    Overload protection (the reference's BRPC ``max_concurrency`` /
    heartbeat role, shared by every service built on this class):

    - **Admission control** — ``FLAGS_wire_max_inflight`` caps concurrent
      in-flight requests and ``FLAGS_wire_max_conns`` caps accepted
      connections; excess work is shed fast with :data:`CODE_SHED`
      (``{"error": ..., "retry_after_s": t}``) instead of queueing
      unboundedly behind a slow model.
    - **Universal health op** — op :data:`HEALTH_OP` is answered by this
      class itself (never ``_dispatch``) with liveness, in-flight/conn
      depth, uptime, and a monitor-stats snapshot, and is never shed, so
      load balancers can probe any service uniformly even under overload.
    - **Graceful drain** — :meth:`drain` stops accepting, sheds new
      requests, lets in-flight ones finish up to a deadline, then severs.
    - **Idle reap** — ``FLAGS_wire_server_idle_s`` bounds how long a
      silent connection may pin a handler thread (``wire/idle_closed``).

    Observability (``FLAGS_trace``): every dispatched request opens a
    server-side span linked to the client's trace context (header keys
    ``tr``/``sp``), records its latency into the
    ``wire/server_latency_s/<Service>.<op>`` histogram, and the reserved
    :data:`TRACE_OP` (never shed, like health) dumps the span ring
    buffer to remote scrapers (``FrameClient.trace_dump()``,
    ``tools/obs_dump.py``). Subclasses set :attr:`op_names` so spans
    carry op names instead of numbers.
    """

    # op number -> name, for span/histogram labeling (subclasses set it;
    # unnamed ops fall back to "op<N>")
    op_names: dict[int, str] = {}

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                with outer._conns_lock:
                    late = outer._stopping
                    if not late:
                        outer._conns.add(sock)
                        n_conns = len(outer._conns)
                if late:
                    # accepted while stop() was severing: the sweep has
                    # already read _conns, so never serve this socket
                    # (BaseServer closes it after handle() returns)
                    return
                try:
                    max_conns = int(flag("wire_max_conns"))
                    if max_conns > 0 and n_conns > max_conns:
                        # over the connection cap: answer the first
                        # request with a shed frame (so the client backs
                        # off instead of seeing an opaque reset), close
                        stat_add("wire/shed_conns")
                        sock.settimeout(5.0)
                        try:
                            recv_frame(sock)
                            outer._shed_frame(sock, "connection limit "
                                              "reached", closing=True)
                        except (ConnectionError, OSError):
                            pass
                        return
                    idle = float(flag("wire_server_idle_s"))
                    if idle > 0:
                        sock.settimeout(idle)
                    while True:
                        try:
                            op, header, payload = recv_frame(sock)
                        except TimeoutError:
                            stat_add("wire/idle_closed")
                            return
                        if op == HEALTH_OP:
                            # served here, never by subclasses — and
                            # never shed: probes must answer under load
                            send_frame(sock, 0, outer.health(
                                header.get("stats_prefix"),
                                bool(header.get("histograms")),
                                bool(header.get("deep")),
                                stats=bool(header.get("stats", True))))
                            continue
                        if op == TRACE_OP:
                            # span scrape: never shed either (observing
                            # an overloaded service is the whole point)
                            send_frame(sock, 0, outer.trace_dump(
                                bool(header.get("clear"))))
                            continue
                        admitted, reason = outer._try_admit(header)
                        if not admitted:
                            stat_add("wire/shed_server")
                            outer._shed_frame(sock, reason)
                            continue
                        try:
                            if _trace._ACTIVE is not None:
                                keep = outer._traced_dispatch(
                                    sock, op, header, payload)
                            else:
                                keep = outer._dispatch(sock, op, header,
                                                       payload)
                        finally:
                            outer._release()
                        if not keep:
                            return
                except (ConnectionError, OSError):
                    return
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(sock)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._load_cv = threading.Condition()
        self._inflight = 0
        # optional admission gate consulted on the WOULD-SHED path only
        # (set_shed_gate): lets one policy object (the gen scheduler)
        # own both wire- and engine-level shed decisions, so a request
        # is never double-shed. None (default) = plain cap behavior.
        self._shed_gate = None
        self._draining = False
        self._stopping = False
        self._started: float | None = None
        self._lifecycle_lock = threading.Lock()
        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: threading.Thread | None = None

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._started = time.monotonic()
        return self

    # -- admission control -------------------------------------------------
    def set_shed_gate(self, gate) -> None:
        """Install ``gate(header, inflight, cap) -> bool`` consulted
        when admission WOULD shed on the in-flight cap (never on
        drain/stop): True admits past the cap — how interactive-class
        traffic gets bounded headroom under a scheduler (ROADMAP A2d in
        the port). Pass None to restore the plain cap."""
        with self._load_cv:
            self._shed_gate = gate

    def _try_admit(self, header: dict | None = None
                   ) -> tuple[bool, str | None]:
        """Atomic admit-or-shed decision: check and increment under one
        lock, so the in-flight count can never overshoot the cap (plus
        whatever bounded headroom an installed shed gate grants)."""
        with self._load_cv:
            if self._draining or self._stopping:
                return False, "draining"
            cap = int(flag("wire_max_inflight"))
            if cap > 0 and self._inflight >= cap:
                gate = self._shed_gate
                if gate is None or not gate(header, self._inflight, cap):
                    return False, "overloaded"
            self._inflight += 1
            return True, None

    def _release(self) -> None:
        with self._load_cv:
            self._inflight -= 1
            self._load_cv.notify_all()

    def _shed_frame(self, sock, reason: str, *, closing: bool = False):
        """Fast rejection: the request was NOT executed; the client may
        retry any op after ``retry_after_s`` — jittered (U[0.5, 1.5) of
        the base), so a crowd of clients shed in the same instant does
        not come back in the same instant."""
        retry_after = float(flag("wire_backoff_s"))
        retry_after *= 0.5 + random.random()
        if reason == "draining":   # we are going away: jittered floor
            retry_after = max(retry_after, 0.5 + 0.5 * random.random())
        header: dict[str, Any] = {
            "error": f"{type(self).__name__} {reason}",
            "retry_after_s": retry_after}
        if closing:
            header["closing"] = True
        send_frame(sock, CODE_SHED, header)

    # -- observability -----------------------------------------------------
    def _op_name(self, op: int) -> str:
        return self.op_names.get(op) or f"op{op}"

    def _traced_dispatch(self, sock, op: int, header: dict,
                         payload: bytes) -> bool:
        """Dispatch wrapped in a server span linked to the client's
        trace context (one trace id across the wire) + a per-op server
        latency histogram. Only called while tracing is active."""
        name = f"{type(self).__name__}.{self._op_name(op)}"
        t0 = time.perf_counter()
        with _trace.server_span(f"wire/{name}",
                                header.get(_TRACE_ID_KEY),
                                header.get(_TRACE_PARENT_KEY)):
            keep = self._dispatch(sock, op, header, payload)
        observe(f"wire/server_latency_s/{name}", time.perf_counter() - t0)
        return keep

    def trace_dump(self, clear: bool = False) -> dict:
        """Span ring-buffer snapshot, served to any client as op
        :data:`TRACE_OP` (``FrameClient.trace_dump()``) — never shed."""
        doc = _trace.snapshot(clear_after=clear)
        doc["service"] = type(self).__name__
        doc["endpoint"] = self.endpoint
        return doc

    # -- health ------------------------------------------------------------
    def health(self, stats_prefix: str | None = None,
               histograms: bool = False, deep: bool = False,
               stats: bool = True) -> dict:
        """Uniform liveness/load snapshot, also served to any client as
        op :data:`HEALTH_OP` (``FrameClient.health()``). ``stats_prefix``
        (probe-header ``stats_prefix``) filters the monitor-stats
        snapshot so high-frequency pollers don't ship every counter each
        probe (``""`` still means everything; pass a non-matching prefix
        for none). ``histograms`` (probe-header ``histograms``) adds the
        matching latency histograms with raw bucket counts, so fleet
        scrapers (``tools/obs_dump.py``) can merge distributions across
        endpoints instead of averaging quantiles. ``deep`` (probe-header
        ``deep``) asks for a work-proving liveness probe where the
        service has one — the base service ignores it (wire liveness IS
        its work); ``InferenceServer`` runs a one-token canary decode
        per generation engine, distinguishing "port open" from "device
        healthy". ``stats=False`` (probe-header ``stats``) skips the
        stats snapshot entirely (``doc["stats"] == {}``) — the
        liveness-only probe path, replacing the old non-matching-prefix
        trick (which still works)."""
        if stats_prefix is not None:
            stats_prefix = str(stats_prefix)   # header value is untrusted
        with self._load_cv:
            inflight = self._inflight
            draining = self._draining or self._stopping
        with self._conns_lock:
            conns = len(self._conns)
        doc = {
            "status": "draining" if draining else "ok",
            "service": type(self).__name__,
            "endpoint": self.endpoint,
            "inflight": inflight,
            "conns": conns,
            "max_inflight": int(flag("wire_max_inflight")),
            "max_conns": int(flag("wire_max_conns")),
            "uptime_s": (time.monotonic() - self._started
                         if self._started is not None else 0.0),
            "stats": export_stats(stats_prefix) if stats else {},
        }
        if histograms:
            doc["histograms"] = export_histograms(stats_prefix, raw=True)
        return doc

    # -- lifecycle ---------------------------------------------------------
    def _stop_accepting(self) -> None:
        with self._lifecycle_lock:
            if self._thread is not None:  # shutdown() hangs unless serving
                self._server.shutdown()
                self._thread = None
            self._server.server_close()

    def drain(self, deadline: float | None = None) -> bool:
        """Graceful shutdown: stop accepting new connections, shed new
        requests (:data:`CODE_SHED` ``draining``), wait up to ``deadline``
        seconds for in-flight requests to finish, then sever whatever is
        left. Returns True when everything in flight completed."""
        with self._load_cv:
            self._draining = True
        self._stop_accepting()
        stat_add("wire/drains")
        with self._load_cv:
            clean = self._load_cv.wait_for(lambda: self._inflight == 0,
                                           timeout=deadline)
        if not clean:
            stat_add("wire/drain_severed")
        self.stop()
        return clean

    def stop(self, drain_s: float | None = None) -> None:
        """Stop the service. With ``drain_s`` (seconds) the shutdown is
        graceful — in-flight requests get that long to finish (see
        :meth:`drain`); without it, connections are severed immediately."""
        if drain_s is not None and drain_s > 0:
            self.drain(drain_s)   # ends with a hard stop() of its own
            return
        self._stop_accepting()
        # sever established connections too — a stopped service must look
        # like a dead process to its clients (EOF/RST now), not leave
        # handler threads silently serving stale sockets forever.
        # _stopping is flipped under the conns lock BEFORE the sweep so a
        # connection accepted during it closes itself instead of being
        # added after the sweep already read the set.
        with self._conns_lock:
            self._stopping = True
            conns, self._conns = list(self._conns), set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _dispatch(self, sock, op: int, header: dict,
                  payload: bytes) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError


class FrameClient:
    """Single-connection client over the frame protocol; thread-safe
    request/response with server errors surfaced as RuntimeError.

    Fault tolerance (flags ``wire_timeout_s``/``wire_retries``/
    ``wire_backoff_s``): connect and each request round-trip carry a
    deadline, and ops named in ``idempotent`` are retried across a
    transparent reconnect with exponential backoff + jitter when the
    connection dies or times out — a restarted server is picked up
    mid-stream. Non-idempotent ops (grad pushes, appends, barriers) fail
    fast after closing the broken socket. Retries/reconnects/timeouts
    increment ``wire/*`` stats in ``core/monitor``.

    Overload cooperation: a :data:`CODE_SHED` response means the server
    rejected the request *before executing it* (admission control or
    drain), so it is retried with backoff — honoring the server's
    ``retry_after_s`` hint and counting ``wire/shed`` — for every op,
    idempotent or not.
    """

    def __init__(self, endpoint: str, ops: dict[str, int],
                 service: str = "service", *, timeout: float | None = None,
                 retries: int | None = None,
                 idempotent: Iterable[str] = ()):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self._addr = (host, int(port))
        self._timeout = (flag("wire_timeout_s") if timeout is None
                         else timeout)
        self._retries = (int(flag("wire_retries")) if retries is None
                         else int(retries))
        self._idempotent = frozenset(idempotent)
        self._lock = threading.Lock()
        # Per-op in-flight counts (requests submitted but not yet
        # answered, INCLUDING ones queued on the connection lock): the
        # load signal serving.RoutedClient balances replicas on.
        self._inflight_lock = threading.Lock()
        self._inflight_by_op: dict[str, int] = {}
        self._ops = ops
        self._service = service
        self._closed = False
        self._sock: socket.socket | None = None
        self._connect()

    @property
    def _deadline(self) -> float | None:
        return self._timeout if self._timeout and self._timeout > 0 else None

    def _connect(self) -> None:
        t = self._deadline
        sock = socket.create_connection(self._addr, timeout=t)
        # Enforce the request deadline with kernel SO_RCVTIMEO/SO_SNDTIMEO
        # on a BLOCKING socket: settimeout() would flip the socket to
        # non-blocking and pay a poll() before every send/recv — the
        # kernel option keeps the fast path at exactly the seed's syscall
        # count (a timed-out op surfaces as EAGAIN).
        sock.settimeout(None)
        self._kernel_deadline = False
        if t is not None:
            try:
                tv = struct.pack("ll", int(t), int((t % 1.0) * 1e6))
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
                self._kernel_deadline = True
            except (OSError, struct.error):   # exotic platform: poll path
                sock.settimeout(t)
        self._sock = sock

    def _backoff(self, attempt: int) -> float:
        base = float(flag("wire_backoff_s")) * (2 ** attempt)
        base = min(base, float(flag("wire_backoff_max_s")))
        return base * (0.5 + random.random())      # +/-50% jitter

    @staticmethod
    def _is_timeout(e: BaseException) -> bool:
        # settimeout path raises TimeoutError; the kernel SO_RCVTIMEO
        # path surfaces as EAGAIN/EWOULDBLOCK on a blocking socket
        import errno

        return (isinstance(e, (TimeoutError, socket.timeout))
                or getattr(e, "errno", None) in (errno.EAGAIN,
                                                 errno.EWOULDBLOCK))

    @property
    def inflight(self) -> int:
        """Requests currently submitted through this client and not yet
        answered (executing or queued on the connection)."""
        with self._inflight_lock:
            return sum(self._inflight_by_op.values())

    def inflight_by_op(self) -> dict[str, int]:
        """Snapshot of the per-op in-flight counts (ops at zero are
        omitted)."""
        with self._inflight_lock:
            return {k: v for k, v in self._inflight_by_op.items() if v}

    def health(self, stats_prefix: str | None = None,
               histograms: bool = False, deep: bool = False,
               stats: bool = True) -> dict:
        """Probe the server's universal health op (:data:`HEALTH_OP`,
        served by ``FrameService`` itself for every service): liveness,
        in-flight/connection depth, drain status, uptime, stats.
        ``stats_prefix`` asks the server to filter the stats snapshot
        (high-frequency pollers shouldn't ship every counter);
        ``stats=False`` skips the stats snapshot entirely — the
        cheapest liveness-only probe; ``histograms`` also ships the
        matching raw-bucket histograms (mergeable across endpoints —
        see ``monitor.merge_histograms``); ``deep`` asks for the
        work-proving probe (an InferenceServer runs a one-token canary
        decode per generation engine — engine liveness distinct from
        the wire liveness this op otherwise measures). Deep probes cost
        real device work; keep them off the high-frequency path."""
        header: dict[str, Any] = {}
        if stats_prefix is not None:
            header["stats_prefix"] = stats_prefix
        if histograms:
            header["histograms"] = True
        if deep:
            header["deep"] = True
        if not stats:
            header["stats"] = False
        return self._request("health", header, idempotent=True)[0]

    def trace_dump(self, clear: bool = False) -> dict:
        """Scrape the server's span ring buffer (:data:`TRACE_OP`, never
        shed). ``clear`` drains it server-side after the dump."""
        header = {"clear": True} if clear else {}
        return self._request("trace_dump", header, idempotent=True)[0]

    def _request(self, op: str, header: dict, payload: bytes = b"",
                 idempotent: bool | None = None,
                 timeout: float | None = None):
        """``timeout`` overrides the client deadline for this request
        only (ops with a known longer server-side wait, e.g. the PS
        barrier); ``idempotent`` overrides the constructor's op set."""
        if idempotent is None:
            idempotent = op in self._idempotent
        try:
            opnum = self._ops[op]
        except KeyError:
            # universal FrameService ops, outside every subclass op table
            if op == "health":
                opnum = HEALTH_OP
            elif op == "trace_dump":
                opnum = TRACE_OP
            else:
                raise
        with self._inflight_lock:
            self._inflight_by_op[op] = self._inflight_by_op.get(op, 0) + 1
        try:
            # Tracing (FLAGS_trace, hard-off default — this is the only
            # check the fast path pays beyond the inflight count): one
            # client span covers the whole logical request including
            # retries, and its ids ride the header so the server links
            # its span into the same trace.
            if _trace._ACTIVE is not None:
                return self._traced_request(op, opnum, header, payload,
                                            idempotent, timeout)
            return self._request_inner(op, opnum, header, payload,
                                       idempotent, timeout)
        finally:
            with self._inflight_lock:
                self._inflight_by_op[op] -= 1

    def _traced_request(self, op, opnum, header, payload, idempotent,
                        timeout):
        name = f"wire/{self._service}.{op}"
        t0 = time.perf_counter()
        with _trace.span(name, endpoint=self.endpoint) as sp:
            if sp.trace_id is not None:     # tracing still on
                header = dict(header)
                header[_TRACE_ID_KEY] = sp.trace_id
                header[_TRACE_PARENT_KEY] = sp.span_id
            try:
                return self._request_inner(op, opnum, header, payload,
                                           idempotent, timeout)
            finally:
                observe(f"wire/op_latency_s/{self._service}.{op}",
                        time.perf_counter() - t0)

    def _request_inner(self, op, opnum, header, payload, idempotent,
                       timeout):
        # Two independent retry budgets (both sized by wire_retries):
        # connection failures/timeouts are retried only for idempotent
        # ops, but CODE_SHED rejections were never executed server-side,
        # so they are retryable-with-backoff for EVERY op.
        conn_budget = (self._retries if idempotent else 0) + 1
        shed_budget = self._retries + 1
        conn_fails = sheds = 0
        with self._lock:
            if self._closed:
                raise ConnectionError(
                    f"{self._service} client for {self.endpoint} is closed")
            while True:
                try:
                    if self._sock is None:
                        self._connect()
                        stat_add("wire/reconnects")
                    if timeout is not None:
                        self._sock.settimeout(
                            timeout if timeout > 0 else None)
                    if _fault._ACTIVE is not None:
                        _fault.inject("wire.send")
                    send_frame(self._sock, opnum, header, payload)
                    # replies come from the server this client chose to
                    # connect to — no size cap (a large pull/infer reply
                    # is legitimate)
                    code, rheader, rpayload = recv_frame(self._sock,
                                                         max_payload=None)
                    if _fault._ACTIVE is not None:
                        _fault.inject("wire.recv")
                    if timeout is not None:
                        # back to the standing deadline (kernel sockopts
                        # still armed in the blocking-mode path)
                        self._sock.settimeout(
                            None if self._kernel_deadline
                            else self._deadline)
                except (ConnectionError, TimeoutError, OSError) as e:
                    if self._is_timeout(e):
                        stat_add("wire/timeouts")
                    self._close_locked()
                    conn_fails += 1
                    if conn_fails >= conn_budget:
                        raise ConnectionError(
                            f"{self._service} {op} to {self.endpoint} "
                            f"failed after {conn_fails} attempt(s): "
                            f"{type(e).__name__}: {e}") from e
                    stat_add("wire/retries")
                    wait = self._backoff(conn_fails - 1)
                    observe("wire/retry_wait_s", wait)
                    # child of the request span when tracing: retries are
                    # visible on the timeline, not silent gaps
                    with _trace.span("wire/retry_wait", op=op,
                                     attempt=conn_fails):
                        time.sleep(wait)
                    continue
                if code == CODE_SHED:
                    # admission control turned the request away before it
                    # ran: back off (honoring the server's hint) and retry
                    stat_add("wire/shed")
                    if rheader.get("closing"):
                        self._close_locked()   # server is hanging up
                    sheds += 1
                    if sheds >= shed_budget:
                        raise WireShedError(
                            f"{self._service} {op} shed by {self.endpoint} "
                            f"after {sheds} attempt(s): "
                            f"{rheader.get('error')}")
                    wait = max(float(rheader.get("retry_after_s", 0.0)),
                               self._backoff(sheds - 1))
                    observe("wire/shed_wait_s", wait)
                    with _trace.span("wire/shed_wait", op=op,
                                     attempt=sheds):
                        time.sleep(wait)
                    continue
                break
        if code != 0:
            raise RuntimeError(
                f"{self._service} {op} failed: {rheader.get('error')}")
        return rheader, rpayload

    def _close_locked(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        """Idempotent; a closed client refuses further requests."""
        with self._lock:
            self._closed = True
            self._close_locked()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
