"""Generation serving over TCP — the port of ``paddle_tpu/io/serving.py``'s
``InferenceServer`` and ``InferenceClient`` with the generation ops.

``InferenceServer.add_generator`` registers a continuous-batching
:class:`~paddle_tpu_torch.serving.engine.GenerationEngine` over a live
model, served through ``generate_start`` / ``generate_poll`` /
``generate_cancel`` (prompts and tokens ride the JSON header: they are
small) on the shared frame protocol (``core/wire.py``), whose frames are
the JAX package's byte for byte: a JAX ``InferenceClient`` talks to this
server and this client to a JAX server. :meth:`InferenceClient.generate`
is the streaming iterator; closing it early cancels the generation on
the server. A full engine sheds a start with the retryable ``CODE_SHED``
status. The ``health`` op ships each generator's ``stats()`` (slots, in
paged mode the page pool and prefix cache, ``tokens_per_step``, the
``device`` block), and with ``deep=True`` a one-token canary per engine;
``ledger_dump`` ships each engine's request ledger.

Threads: the server's handler threads call the engines' ``start`` /
``poll`` / ``cancel`` / ``stats`` / ``canary``, which are host-side and
lock-guarded; only each engine's own loop thread touches the device.

Not ported yet, answered as wire errors naming their ROADMAP item:
serving exported artifacts (``infer``, ``load_model``, ``unload_model``,
``add_model``, ``models=``: the JAX package's ``io/export.py``
``Predictor``, A7), and the KV page store and scheduler ops
(``kv_put``, ``kv_get``, ``kv_probe``, ``sched_quotas``: A2d). The
``tn`` tenant header is booked by the engine's ledger; the ``fp``
fingerprint and ``pc`` priority headers are inert here (quarantine and
the scheduler are A2d), as in the JAX package with those features off.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from paddle_tpu_torch.core import trace as _trace
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.core.monitor import stat_add
from paddle_tpu_torch.core.wire import (CODE_SHED, FrameClient, FrameService,
                                        send_frame)

__all__ = ["InferenceServer", "InferenceClient", "ModelBusyError",
           "SERVING_OPS"]

# the JAX package's op table (``paddle_tpu/io/serving.py:52-56``)
SERVING_OPS = {"infer": 1, "list_models": 2, "load_model": 3, "stop": 4,
               "generate_start": 5, "generate_poll": 6,
               "generate_cancel": 7, "unload_model": 8, "ledger_dump": 9,
               "kv_put": 10, "kv_get": 11, "kv_probe": 12,
               "sched_quotas": 13}
_OP_NAMES = {v: k for k, v in SERVING_OPS.items()}
_ADMIN_OPS = ("stop", "load_model", "unload_model", "sched_quotas")
_LOOPBACK = ("127.0.0.1", "localhost", "::1")

# Marker prefix of the typed busy error as it crosses the wire.
_BUSY_MARKER = "model busy:"


class ModelBusyError(RuntimeError):
    """``unload_model`` refused while the model has requests in flight
    (the JAX package's type; a JAX server may raise it)."""


def _pack_arrays(arrays) -> tuple[list[dict], bytes]:
    specs, chunks = [], []
    for a in arrays:
        a = np.ascontiguousarray(a)
        specs.append({"shape": list(a.shape), "dtype": a.dtype.name})
        chunks.append(a.tobytes())
    return specs, b"".join(chunks)


def _unpack_arrays(specs: list[dict], payload: bytes) -> list[np.ndarray]:
    out, off = [], 0
    for spec in specs:
        dt = np.dtype(spec["dtype"])
        count = int(np.prod(spec["shape"]))
        n = count * dt.itemsize
        if off + n > len(payload):
            raise ValueError("payload shorter than declared specs")
        out.append(np.frombuffer(payload, dt, count=count, offset=off)
                   .reshape(spec["shape"]))
        off += n
    if off != len(payload):
        raise ValueError("payload longer than declared specs")
    return out


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not ported yet (ROADMAP {item})")


class InferenceServer(FrameService):
    """Serve generation engines over TCP.

    ``admin_ops`` controls the mutating wire ops (``stop``, and the
    unported ``load_model`` / ``unload_model`` / ``sched_quotas``).
    Default: enabled only when bound to loopback; a server exposed
    beyond localhost serves the data-plane ops and admin must be opted
    into. ``models`` (exported artifacts) is ROADMAP A7 and raises when
    given."""

    op_names = _OP_NAMES           # span and histogram labels (wire.py)

    def __init__(self, models: dict[str, Any] | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 admin_ops: bool | None = None):
        if models:
            raise _unported("InferenceServer(models=...) (serving "
                            "exported artifacts)", "A7")
        self._generators: dict[str, Any] = {}
        self._lock = threading.Lock()
        if admin_ops is None:
            admin_ops = host in _LOOPBACK
        self._admin_ops = bool(admin_ops)
        # set once stop() has severed the connections and closed the
        # engines (a replica process waits on it before it exits)
        self.stopped = threading.Event()
        super().__init__(host, port)

    def add_model(self, name: str, model) -> None:
        """Serving an exported artifact needs the ``Predictor`` of the
        JAX package's ``io/export.py``: ROADMAP A7."""
        raise _unported(f"InferenceServer.add_model({name!r})", "A7")

    def unload_model(self, name: str) -> bool:
        raise _unported(f"InferenceServer.unload_model({name!r})", "A7")

    def add_generator(self, name: str, model, **engine_kwargs) -> None:
        """Register a :class:`~paddle_tpu_torch.serving.engine.
        GenerationEngine` for the generation ops: ``model`` is a live
        model of the port (``init_cache``/``forward_with_cache``) built
        on its device, or an engine. ``engine_kwargs`` go to the engine
        (``slots``, ``max_len``, ``paged``, ``page_tokens``, ``pages``,
        ``prefill_chunk``, ``prefix_cache``, ``cache_dtype``, ...). A
        generator registered again under one name closes the old
        engine."""
        from paddle_tpu_torch.serving.engine import GenerationEngine

        engine = (model if isinstance(model, GenerationEngine)
                  else GenerationEngine(model, **engine_kwargs))
        with self._lock:
            old = self._generators.get(name)
            self._generators[name] = engine
        if old is not None and old is not engine:
            old.close()

    def _generator(self, name: str):
        with self._lock:
            eng = self._generators.get(name)
        if eng is None:
            raise KeyError(f"no generator {name!r}; registered: "
                           f"{sorted(self._generators)} (use "
                           "add_generator)")
        return eng

    def _engines(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._generators)

    def health(self, stats_prefix: str | None = None,
               histograms: bool = False, deep: bool = False,
               stats: bool = True) -> dict:
        """FrameService health plus each generator's ``stats()`` (slot
        occupancy; in paged mode ``pages_free``/``pages`` and
        ``prefix_entries``; ``tokens_per_step``; the ``device`` block),
        read from host-side state only. ``deep`` also runs a one-token
        canary per engine (``GenerationEngine.canary``) and ships it
        under the generator's ``engine`` key. ``models`` is empty: the
        port serves no exported artifacts (A7)."""
        doc = super().health(stats_prefix, histograms, deep, stats)
        engines = self._engines()
        gens = {n: e.stats() for n, e in engines.items()}
        if deep:
            for n, e in engines.items():
                gens[n]["engine"] = e.canary()
        if gens:
            doc["generators"] = gens
        doc["models"] = {}
        return doc

    def stop(self, drain_s: float | None = None) -> None:
        super().stop(drain_s)
        for engine in self._engines().values():
            engine.close()
        self.stopped.set()

    def _generate_start(self, sock, header: dict) -> None:
        from paddle_tpu_torch.serving.engine import EngineOverloaded

        engine = self._generator(header["model"])
        eos = header.get("eos_token_id")
        try:
            gen_id = engine.start(
                np.asarray(header["prompt"], np.int32),
                int(header["max_new_tokens"]),
                temperature=float(header.get("temperature", 0.0)),
                top_k=int(header.get("top_k", 0)),
                top_p=float(header.get("top_p", 1.0)),
                eos_token_id=None if eos is None else int(eos),
                seed=int(header.get("seed", 0)),
                rng_skip=int(header.get("rng_skip", 0)),
                # the stream's trace id ("st") and tenant ("tn")
                trace_id=header.get("st"), tenant=header.get("tn"))
        except EngineOverloaded as e:
            # a full engine: shed, not an error (the start never ran)
            stat_add("gen/shed_wire")
            send_frame(sock, CODE_SHED, {"error": str(e),
                                         "retry_after_s": e.retry_after_s})
            return
        send_frame(sock, 0, {"gen_id": gen_id})

    def _dispatch(self, sock, op: int, header: dict, payload: bytes) -> bool:
        name = _OP_NAMES.get(op)
        try:
            if name in _ADMIN_OPS and not self._admin_ops:
                send_frame(sock, 1, {"error": f"admin op {name!r} disabled "
                                     "on this server (admin_ops=False)"})
                return True
            if name == "stop":
                send_frame(sock, 0, {})
                # graceful: other in-flight requests get wire_drain_s to
                # finish before their sockets are severed
                threading.Thread(
                    target=self.stop,
                    kwargs={"drain_s": float(flag("wire_drain_s"))},
                    daemon=True).start()
                return False
            if name == "list_models":
                send_frame(sock, 0, {"models": {}})
            elif name == "generate_start":
                self._generate_start(sock, header)
            elif name == "generate_poll":
                doc = self._generator(header["model"]).poll(
                    header["gen_id"], start=int(header.get("start", 0)),
                    # bound the long poll: it pins a handler thread
                    wait_s=min(float(header.get("wait_s", 0.0)), 2.0))
                send_frame(sock, 0, doc)
            elif name == "generate_cancel":
                engine = self._generator(header["model"])
                send_frame(sock, 0,
                           {"cancelled": engine.cancel(header["gen_id"])})
            elif name == "ledger_dump":
                # each engine's records, tenant book and goodput; engines
                # with the ledger off are omitted. No infer book: infer is
                # A7
                limit = header.get("limit")
                gens = {}
                for n, e in self._engines().items():
                    d = e.ledger_dump(None if limit is None else int(limit))
                    if d is not None:
                        gens[n] = d
                send_frame(sock, 0, {"generators": gens,
                                     "infer_tenants": None})
            elif name in ("infer", "load_model", "unload_model"):
                raise _unported(f"the {name!r} op (serving exported "
                                "artifacts)", "A7")
            elif name in ("kv_put", "kv_get", "kv_probe", "sched_quotas"):
                raise _unported(f"the {name!r} op (the KV page store and "
                                "the scheduler)", "A2d")
            else:
                send_frame(sock, 1, {"error": f"bad op {op}"})
            return True
        except Exception as e:  # report, keep serving
            send_frame(sock, 1, {"error": f"{type(e).__name__}: {e}"})
            return True


class InferenceClient(FrameClient):
    """Client of :class:`InferenceServer` (and of the JAX package's).

    ``generate_poll``, ``generate_cancel`` and the read-only ops are
    idempotent and retried across reconnects (flags ``wire_retries`` /
    ``wire_timeout_s``); ``generate_start`` is not (a connection-level
    retry could start the generation twice; a shed start never ran and
    is retried); ``stop`` fails fast."""

    def __init__(self, endpoint: str, *, timeout: float | None = None,
                 retries: int | None = None):
        super().__init__(endpoint, SERVING_OPS, service="serving",
                         timeout=timeout, retries=retries,
                         idempotent=("infer", "list_models", "load_model",
                                     "unload_model", "generate_poll",
                                     "generate_cancel", "ledger_dump",
                                     "kv_put", "kv_get", "kv_probe",
                                     "sched_quotas"))

    def infer(self, model: str, *inputs,
              tenant: str | None = None) -> list[np.ndarray]:
        """Run an exported model on the server: the inputs' raw buffers
        in one frame (the JAX package's format). A port server answers a
        wire error naming ROADMAP A7; a JAX server runs it."""
        specs, payload = _pack_arrays(inputs)
        header = {"model": model, "inputs": specs, "nbytes": len(payload)}
        if tenant:
            header["tn"] = str(tenant)
        rheader, rpayload = self._request("infer", header, payload)
        return [np.array(a) for a in
                _unpack_arrays(rheader["outputs"], rpayload)]

    def list_models(self) -> dict:
        return self._request("list_models", {})[0]["models"]

    # -- streaming generation ----------------------------------------------
    def generate_start(self, model: str, prompt, max_new_tokens: int, *,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, eos_token_id: int | None = None,
                       seed: int = 0, rng_skip: int = 0,
                       trace_id: str | None = None,
                       tenant: str | None = None,
                       fingerprint: str | None = None,
                       priority: str | None = None) -> str:
        """Admit a generation into ``model``'s engine; returns its id. A
        full engine answers the retryable shed status (the client backs
        off per ``retry_after_s`` and retries within its budget, then
        raises :class:`~paddle_tpu_torch.core.wire.WireShedError`).
        ``rng_skip`` starts a sampled stream that many tokens in (a
        resumed stream). ``trace_id`` (header ``st``) is the stream's
        trace id, minted here with tracing on when not given; ``tenant``
        (``tn``) the identity the engine's ledger books it under;
        ``fingerprint`` (``fp``) and ``priority`` (``pc``) are carried
        for servers that read them (the JAX package's quarantine and
        scheduler), and a quarantined request re-raises
        :class:`~paddle_tpu_torch.serving.engine.RequestQuarantined`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        header = {"model": model, "prompt": prompt.tolist(),
                  "max_new_tokens": int(max_new_tokens),
                  "temperature": float(temperature), "top_k": int(top_k),
                  "top_p": float(top_p), "seed": int(seed)}
        if eos_token_id is not None:
            header["eos_token_id"] = int(eos_token_id)
        if rng_skip:
            header["rng_skip"] = int(rng_skip)
        if trace_id is None and _trace.enabled():
            trace_id = _trace.new_id()
        if trace_id:
            header["st"] = str(trace_id)
        if tenant:
            header["tn"] = str(tenant)
        if fingerprint:
            header["fp"] = str(fingerprint)
        if priority:
            header["pc"] = str(priority)
        try:
            return self._request("generate_start", header)[0]["gen_id"]
        except RuntimeError as e:
            from paddle_tpu_torch.serving.engine import (QUARANTINE_MARKER,
                                                         RequestQuarantined)
            if QUARANTINE_MARKER in str(e):
                raise RequestQuarantined(str(e)) from e
            raise

    def generate_poll(self, model: str, gen_id: str, start: int = 0,
                      wait_s: float = 0.0) -> dict:
        """Tokens past ``start`` (long-polls up to ``wait_s`` on the
        server) → ``{"tokens", "done", "error", "queued"}``. A generation
        the server reaped by its poll TTL re-raises the typed
        :class:`~paddle_tpu_torch.serving.engine.GenerationExpired`."""
        try:
            return self._request(
                "generate_poll", {"model": model, "gen_id": gen_id,
                                  "start": int(start),
                                  "wait_s": float(wait_s)})[0]
        except RuntimeError as e:
            from paddle_tpu_torch.serving.engine import (EXPIRED_MARKER,
                                                         GenerationExpired)
            if EXPIRED_MARKER in str(e):
                raise GenerationExpired(str(e)) from e
            raise

    def generate_cancel(self, model: str, gen_id: str) -> bool:
        return self._request(
            "generate_cancel",
            {"model": model, "gen_id": gen_id})[0]["cancelled"]

    def generate(self, model: str, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id: int | None = None,
                 seed: int = 0, poll_wait_s: float = 0.25,
                 tenant: str | None = None):
        """Streaming generation: admits the prompt (a start the server
        sheds past the retry budget raises here) and returns an iterator
        of token ids as the engine emits them. Closing the iterator early
        (``break`` / ``.close()``) cancels the generation on the server,
        so its slot frees now instead of at the poll TTL."""
        gen_id = self.generate_start(
            model, prompt, max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_token_id=eos_token_id,
            seed=seed, tenant=tenant)

        def stream():
            n, finished = 0, False
            try:
                while True:
                    doc = self.generate_poll(model, gen_id, start=n,
                                             wait_s=poll_wait_s)
                    for tok in doc["tokens"]:
                        yield int(tok)
                    n += len(doc["tokens"])
                    if doc["done"]:
                        finished = True
                        if doc.get("error"):
                            raise RuntimeError(
                                f"generation {gen_id} failed: "
                                f"{doc['error']}")
                        return
            finally:
                if not finished:
                    try:
                        self.generate_cancel(model, gen_id)
                    except (RuntimeError, ConnectionError, OSError):
                        pass

        return stream()

    def ledger_dump(self, limit: int | None = None) -> dict:
        """The request ledgers (``FLAGS_gen_ledger``): ``{"generators":
        {name: {records, tenants, goodput}}, "infer_tenants": ...}``;
        engines with the ledger off contribute nothing. ``limit`` caps
        the records per engine."""
        header: dict[str, Any] = {}
        if limit is not None:
            header["limit"] = int(limit)
        return self._request("ledger_dump", header)[0]

    def load_model(self, name: str, path: str) -> None:
        self._request("load_model", {"name": name, "path": path})

    def unload_model(self, name: str) -> bool:
        try:
            return self._request("unload_model",
                                 {"name": name})[0]["unloaded"]
        except RuntimeError as e:
            if _BUSY_MARKER in str(e):
                raise ModelBusyError(str(e)) from e
            raise

    def stop_server(self) -> None:
        try:
            self._request("stop", {})
        except (RuntimeError, ConnectionError, OSError):
            pass
