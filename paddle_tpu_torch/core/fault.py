"""Deterministic, flag-gated fault injection — the port's copy of
``paddle_tpu/core/fault.py``. Code paths name injection sites:

    ``wire.send`` / ``wire.recv``   — a FrameClient request's round trip
                                      (core/wire.py), before the send and
                                      after the reply
    ``engine.prefill``              — GenerationEngine prefill, whole and
                                      chunked (serving/engine.py)
    ``engine.decode_step``          — the batched decode step
    ``paged.alloc``                 — page-pool allocation at admission

``FLAGS_fault_inject`` or :class:`inject_faults` arms them with a
probability and an optional fire cap, drawn from a per-site RNG seeded
from ``FLAGS_fault_seed``. Off by default: :func:`inject` is then one
module-attribute read. A fired fault raises :class:`InjectedFault` and
counts ``fault/injected/<site>``."""

from __future__ import annotations

import random
import threading

from paddle_tpu_torch.core.monitor import stat_add

__all__ = ["InjectedFault", "inject", "enabled", "configure", "reset",
           "inject_faults", "parse_spec", "site_counts"]


class InjectedFault(ConnectionError):
    """An injected failure (a ``ConnectionError``, so transport-level
    handlers treat it like a dead peer)."""


class _Site:
    __slots__ = ("name", "prob", "limit", "rng", "fired", "hits")

    def __init__(self, name: str, prob: float, limit: int | None, seed: int):
        self.name = name
        self.prob = float(prob)
        self.limit = limit
        self.rng = random.Random(f"{seed}:{name}")
        self.fired = 0
        self.hits = 0


_lock = threading.Lock()
_ACTIVE: dict[str, _Site] | None = None   # None == injection fully off


def parse_spec(spec) -> dict[str, tuple[float, int | None]]:
    """``"a=1.0@2, b=0.5"`` → ``{"a": (1.0, 2), "b": (0.5, None)}``;
    dicts pass through (values: prob or (prob, limit))."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        out = {}
        for site, v in spec.items():
            prob, limit = v if isinstance(v, (tuple, list)) else (v, None)
            out[site] = (float(prob), None if limit is None else int(limit))
        return out
    out = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        site, _, rest = part.partition("=")
        probs, _, cap = (rest or "1.0").partition("@")
        out[site.strip()] = (float(probs), int(cap) if cap else None)
    return out


def configure(spec, seed: int | None = None) -> None:
    """(Re)configure injection from a spec; an empty spec turns it off.
    Reconfiguring resets every site's counters and RNG."""
    global _ACTIVE
    parsed = parse_spec(spec)
    if seed is None:
        from paddle_tpu_torch.core.flags import flag

        seed = int(flag("fault_seed"))
    with _lock:
        _ACTIVE = ({site: _Site(site, prob, limit, seed)
                    for site, (prob, limit) in parsed.items()}
                   if parsed else None)


def reset() -> None:
    """Turn injection off (the default)."""
    global _ACTIVE
    with _lock:
        _ACTIVE = None


def enabled() -> bool:
    return _ACTIVE is not None


def site_counts() -> dict[str, tuple[int, int]]:
    """``{site: (hits, fired)}`` of the active configuration (empty when
    off)."""
    active = _ACTIVE
    if active is None:
        return {}
    with _lock:
        return {s.name: (s.hits, s.fired) for s in active.values()}


def inject(site: str) -> None:
    """Injection hook: a no-op unless injection names ``site``; otherwise
    a draw from the site's RNG, raising :class:`InjectedFault` on a
    hit."""
    active = _ACTIVE
    if active is None:
        return
    s = active.get(site)
    if s is None:
        return
    with _lock:
        s.hits += 1
        if s.limit is not None and s.fired >= s.limit:
            return
        if s.prob < 1.0 and s.rng.random() >= s.prob:
            return
        s.fired += 1
        n = s.fired
    stat_add(f"fault/injected/{site}")
    raise InjectedFault(f"injected fault at {site!r} (#{n})")


class inject_faults:
    """Scoped injection: ``with inject_faults({"engine.prefill": (1.0,
    1)}): ...`` restores the previous configuration on exit."""

    def __init__(self, spec, seed: int | None = None):
        self._spec = spec
        self._seed = seed

    def __enter__(self):
        with _lock:
            self._prev = _ACTIVE
        configure(self._spec, self._seed)
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        with _lock:
            _ACTIVE = self._prev
        return False
