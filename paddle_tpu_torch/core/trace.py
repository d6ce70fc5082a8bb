"""Flag-gated in-process span tracing — the port's copy of the part of
``paddle_tpu/core/trace.py`` the serving stack uses. ``FLAGS_trace``
defaults off; hot paths gate on ``_ACTIVE is not None`` and :func:`span`
returns a shared no-op while tracing is off. Spans land in a bounded
thread-safe ring buffer (``FLAGS_trace_buffer`` entries) as JSON-safe
dicts; a span opened with a ``trace_id`` joins that trace, and
:func:`server_span` links the server half of a wire round trip to the
client's span. :func:`snapshot` is what the wire ``trace_dump`` op
serves; :func:`export_chrome` writes the spans as a Chrome trace."""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from typing import Any

from paddle_tpu_torch.core.flags import flag

__all__ = ["span", "server_span", "enabled", "configure", "current",
           "get_spans", "clear", "snapshot", "new_id", "to_chrome_events",
           "export_chrome"]


class _Tracer:
    """Thread-safe span ring buffer."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: deque[dict] = deque(maxlen=max(self.capacity, 1))

    def record(self, span_dict: dict) -> None:
        with self._lock:
            self._buf.append(span_dict)

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


_ACTIVE: _Tracer | None = None    # None == tracing fully off
_lock = threading.Lock()
_ctx = threading.local()          # per-thread stack of (trace_id, span_id)


def configure(enable: bool, capacity: int | None = None) -> None:
    """(Re)configure tracing; wired to ``FLAGS_trace``. Resizing a live
    tracer keeps the newest spans that fit."""
    global _ACTIVE
    with _lock:
        if not enable:
            _ACTIVE = None
            return
        if capacity is None:
            try:
                capacity = int(flag("trace_buffer"))
            except KeyError:       # flag not registered yet (import order)
                capacity = 4096
        tracer = _Tracer(capacity)
        if _ACTIVE is not None:
            with _ACTIVE._lock:
                tracer._buf.extend(_ACTIVE._buf)
        _ACTIVE = tracer


def enabled() -> bool:
    return _ACTIVE is not None


def new_id() -> str:
    return f"{random.getrandbits(64):016x}"


def current() -> tuple[str, str] | None:
    """(trace_id, span_id) of this thread's innermost open span."""
    stack = getattr(_ctx, "stack", None)
    return stack[-1] if stack else None


class _NoopSpan:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    """One open span; records itself into the ring buffer on exit."""

    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "_ts", "_t0")

    def __init__(self, name: str, attrs: dict, trace_id: str | None = None,
                 parent_id: str | None = None):
        self.name = name
        self.attrs = attrs
        if trace_id is None:
            cur = current()
            if cur is not None:
                trace_id, parent_id = cur
            else:
                trace_id = new_id()
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.span_id = new_id()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_ctx, "stack", None)
        if stack is None:
            stack = _ctx.stack = []
        stack.append((self.trace_id, self.span_id))
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        stack = getattr(_ctx, "stack", None)
        if stack:
            stack.pop()
        tracer = _ACTIVE
        if tracer is not None:
            if exc_type is not None:
                self.attrs["error"] = exc_type.__name__
            tracer.record({
                "name": self.name, "ts": self._ts, "dur": dur,
                "tid": threading.get_ident(), "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "attrs": self.attrs})
        return False


def span(name: str, trace_id: str | None = None, **attrs: Any):
    """Open a span: ``with trace.span("gen/prefill", slot=3): ...``;
    ``trace_id`` joins an existing trace (a stream's). A shared no-op
    while tracing is off."""
    if _ACTIVE is None:
        return _NOOP
    return _Span(name, attrs, trace_id=trace_id)


def get_spans() -> list[dict]:
    """Snapshot of the ring buffer (oldest first); [] when disabled."""
    tracer = _ACTIVE
    return tracer.spans() if tracer is not None else []


def server_span(name: str, trace_id: str | None, parent_id: str | None,
                **attrs: Any):
    """Open a span linked to a remote parent (the server half of a wire
    round trip); ``trace_id=None`` (an untraced client) starts a fresh
    trace, so a traced server still records its side."""
    if _ACTIVE is None:
        return _NOOP
    return _Span(name, attrs, trace_id=trace_id, parent_id=parent_id)


def clear() -> None:
    tracer = _ACTIVE
    if tracer is not None:
        tracer.clear()


def snapshot(clear_after: bool = False) -> dict:
    """JSON-safe dump of the ring buffer, what the wire ``trace_dump`` op
    serves; ``clear_after`` empties it after the copy."""
    tracer = _ACTIVE
    if tracer is None:
        return {"enabled": False, "spans": []}
    spans = tracer.spans()
    if clear_after:
        tracer.clear()
    return {"enabled": True, "capacity": tracer.capacity, "spans": spans}


def to_chrome_events(spans: list[dict], pid: int | str = 0,
                     pid_name: str | None = None) -> list[dict]:
    """Spans as Chrome trace events (``ph: "X"``, microseconds);
    ``pid``/``pid_name`` group one process' spans in the viewer."""
    events: list[dict] = []
    if pid_name:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": pid_name}})
    for s in spans:
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"]}
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        args.update(s.get("attrs") or {})
        events.append({
            "name": s["name"], "ph": "X",
            "ts": s["ts"] * 1e6, "dur": s["dur"] * 1e6,
            "pid": pid, "tid": s["tid"], "cat": s["name"].split("/")[0],
            "args": args})
    return events


def export_chrome(path: str | None = None,
                  spans: list[dict] | None = None) -> dict:
    """The buffered spans (or ``spans``) as a Chrome trace document,
    loadable in ``chrome://tracing`` or Perfetto; written to ``path``
    when given."""
    doc = {"traceEvents": to_chrome_events(
        get_spans() if spans is None else spans),
        "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
