"""Per-request latency ledger, engine goodput accounting and per-tenant
attribution (``FLAGS_gen_ledger``, off by default) — the port of
``paddle_tpu/serving/ledger.py``. Three books:

- **Request ledger** (:class:`RequestLedger`). Every generation carries
  monotonic phase stamps set at the engine's lifecycle sites (enqueue →
  admit → first token → done → delivered) and is finalized exactly once at
  whichever retire path ends it. Its phase durations come from
  telescoping clamped boundaries, so ``admit_wait + prefill + decode +
  deliver`` partitions the end-to-end latency by construction. A resumed
  stream (``rng_skip``) carries a resume block. Each finalize also feeds
  the ``gen/phase/*_s`` and ``gen/e2e_s`` histograms.
- **Goodput taxonomy** (:class:`GoodputMeter`). The engine loop notes
  every device section (prefill, decode, or "recompile" for the section
  that captured the decode step's CUDA graph, the port's counterpart of
  an XLA compile) and every deliberate wait (admission idle); ``tick()``
  at each iteration sweeps the unaccounted remainder into the host-gather
  bucket. Bucket seconds sum to 100% of loop wall clock; ``goodput`` =
  useful-token time (prefill + decode) / total. The speculation, watchdog
  and KV-fetch buckets stay at zero in the port (ROADMAP A2c, A2d).
- **Tenant book** (:class:`TenantBook`). ``tenant=`` on
  ``generate_start`` (wire header ``"tn"``) accumulates per-tenant
  tokens, chip-seconds (device wall clock attributed per request: a
  batched decode step splits evenly across the stepped slots), queue wait
  and requests.

Flags are read at construction only; with the ledger off the engine holds
no books and every gate is a single ``is None`` check.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from paddle_tpu_torch.core.monitor import observe

__all__ = ["RequestLedger", "GoodputMeter", "TenantBook", "PHASES",
           "GOODPUT_BUCKETS", "GOODPUT_USEFUL"]

# Request phases, in lifecycle order. Durations come from telescoping
# boundaries, so they always sum exactly to the record's e2e_s.
PHASES = ("admit_wait_s", "prefill_s", "decode_s", "deliver_s")

# Engine-loop wall-clock taxonomy. Every loop second lands in exactly
# one bucket; the buckets named in GOODPUT_USEFUL are "useful token
# work" (the goodput numerator). kv_fetch is time spent pulling pages
# from the KV store at admission — it *replaces* prefill compute, but
# it is transfer, not token work, so it stays out of the numerator.
GOODPUT_BUCKETS = ("prefill", "decode", "spec_verify", "host_gather",
                   "admission_idle", "recompile", "watchdog_stuck",
                   "kv_fetch")
GOODPUT_USEFUL = ("prefill", "decode", "spec_verify")

# Untagged traffic books under this tenant key, so fleet totals still
# add up when only some callers send the "tn" header.
DEFAULT_TENANT = "-"


class TenantBook:
    """Per-tenant consumption counters (tokens, chip-seconds, queue
    wait, requests). Thread-safe; the request ledger's (engine side)."""

    __slots__ = ("_lock", "_tenants")

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, dict[str, float]] = {}

    def add(self, tenant: str | None, *, tokens: int = 0,
            chip_s: float = 0.0, queue_wait_s: float = 0.0,
            requests: int = 0) -> None:
        key = str(tenant) if tenant else DEFAULT_TENANT
        with self._lock:
            t = self._tenants.get(key)
            if t is None:
                t = self._tenants[key] = {
                    "tokens": 0, "chip_seconds": 0.0,
                    "queue_wait_s": 0.0, "requests": 0}
            t["tokens"] += int(tokens)
            t["chip_seconds"] += float(chip_s)
            t["queue_wait_s"] += float(queue_wait_s)
            t["requests"] += int(requests)

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._tenants.items()}


class GoodputMeter:
    """Loop wall-clock taxonomy that sums to 100% by construction.

    The loop thread ``note()``s measured sections as they happen and
    ``tick()``s once per iteration; the tick attributes whatever wall
    time since the previous tick was NOT explicitly noted to the hint
    bucket (host-side gather/bookkeeping normally, ``watchdog_stuck``
    while the engine is latched stuck). Because the remainder is swept
    every tick, bucket seconds always total the elapsed loop time —
    fractions sum to 1.0 whenever any time has passed."""

    __slots__ = ("_lock", "_buckets", "_t0", "_noted", "_ticks")

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets = {b: 0.0 for b in GOODPUT_BUCKETS}
        self._t0 = time.perf_counter()
        self._noted = 0.0
        self._ticks = 0

    def note(self, bucket: str, dt: float) -> None:
        """Attribute ``dt`` seconds of the current iteration to
        ``bucket`` (a measured device call or deliberate wait)."""
        if dt <= 0.0:
            return
        with self._lock:
            self._buckets[bucket] += dt
            self._noted += dt

    def tick(self, hint: str = "host_gather") -> None:
        """Close one loop iteration: sweep the un-noted remainder of
        the wall clock since the last tick into ``hint``."""
        now = time.perf_counter()
        with self._lock:
            rem = (now - self._t0) - self._noted
            if rem > 0.0:
                self._buckets[hint] += rem
            self._t0 = now
            self._noted = 0.0
            self._ticks += 1

    def snapshot(self) -> dict[str, Any]:
        """``{total_s, ticks, buckets, fractions, goodput}`` — the
        ``goodput`` block :meth:`GenerationEngine.stats` ships in
        health (fleet rollup: ``MetricsHub.fleet_goodput``)."""
        with self._lock:
            buckets = dict(self._buckets)
            ticks = self._ticks
        total = sum(buckets.values())
        useful = sum(buckets[b] for b in GOODPUT_USEFUL)
        return {
            "total_s": total,
            "ticks": ticks,
            "buckets": buckets,
            "fractions": {b: (buckets[b] / total if total > 0.0 else 0.0)
                          for b in GOODPUT_BUCKETS},
            "goodput": (useful / total) if total > 0.0 else 0.0,
        }


class RequestLedger:
    """Finalized per-request phase records + the engine's tenant book.

    ``finalize`` is called exactly once per generation (the engine
    guards idempotency with the generation's ``ledgered`` flag, under
    its own lock) at whichever retire path ends it — delivery, cancel,
    TTL reap, engine failure/break, or close. Boundaries telescope:

    ``created <= admitted <= first_token <= done <= end``

    with any missing stamp collapsing to ``end`` and every boundary
    clamped monotone, so the four phase durations sum EXACTLY to
    ``end - created`` (the partition invariant)."""

    __slots__ = ("_lock", "_records", "_book")

    def __init__(self, records: int = 256):
        self._lock = threading.Lock()
        self._records: deque[dict] = deque(maxlen=max(int(records), 1))
        self._book = TenantBook()

    @property
    def book(self) -> TenantBook:
        """The live tenant book."""
        return self._book

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def book_admission(self, gen, now: float | None = None) -> None:
        """Book the generation's queue wait into the tenant book LIVE
        at admission time, so the book shows current per-tenant waits
        instead of only finalized ones. Finalize stays
        authoritative: it books the (clamped) remainder, so per-tenant
        ``queue_wait_s`` totals match the finalize-only path exactly."""
        ts = time.monotonic() if now is None else float(now)
        wait = max(ts - gen.created, 0.0)
        # a preempted-and-readmitted generation books here twice: only
        # the delta past the previous booking is added, so the running
        # total never double counts
        self._book.add(gen.tenant,
                       queue_wait_s=max(wait - gen.queue_booked, 0.0))
        gen.queue_booked = wait

    def finalize(self, gen, outcome: str,
                 now: float | None = None) -> dict:
        """Build, store, and return the generation's phase record;
        feed the phase histograms and the tenant book."""
        end = time.monotonic() if now is None else float(now)
        b0 = min(gen.created, end)
        # missing stamps (0.0 — the site never ran) collapse to the
        # end; clamping keeps the chain monotone even under clock
        # jitter, so phase durations are non-negative and telescope
        b1 = min(max(gen.admitted_ts or end, b0), end)
        b2 = min(max(gen.first_tok_ts or end, b1), end)
        b3 = min(max(gen.done_ts or end, b2), end)
        phases = {"admit_wait_s": b1 - b0, "prefill_s": b2 - b1,
                  "decode_s": b3 - b2, "deliver_s": end - b3}
        e2e = end - b0
        rec: dict[str, Any] = {
            "gen_id": gen.gen_id,
            "tenant": gen.tenant or DEFAULT_TENANT,
            "outcome": outcome,
            "e2e_s": e2e,
            "phases": phases,
            "prompt_len": int(gen.prompt.size),
            "tokens": len(gen.tokens),
            "chip_s": gen.chip_s,
        }
        if gen.rng_skip:
            # resume sub-phase: this generation is a failover replay —
            # rng_skip tokens were already delivered by a prior replica,
            # so its prefill phase includes the prefix re-prefill
            rec["resume"] = {"rng_skip": int(gen.rng_skip)}
        with self._lock:
            self._records.append(rec)
        # queue wait may have been booked live at admission
        # (book_admission); finalize books only the remainder so the
        # per-tenant total is exactly the authoritative admit_wait_s
        self._book.add(rec["tenant"], tokens=len(gen.tokens),
                       chip_s=gen.chip_s,
                       queue_wait_s=(phases["admit_wait_s"]
                                     - getattr(gen, "queue_booked", 0.0)),
                       requests=1)
        observe("gen/e2e_s", e2e)
        for ph, v in phases.items():
            observe(f"gen/phase/{ph}", v)
        return rec

    def records(self, limit: int | None = None) -> list[dict]:
        """Newest-last finalized records (all, or the last ``limit``)."""
        with self._lock:
            out = list(self._records)
        if limit is not None and limit > 0:
            out = out[-int(limit):]
        return out

    def tenants(self) -> dict[str, dict[str, float]]:
        return self._book.snapshot()
