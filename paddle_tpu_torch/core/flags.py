"""Global flag registry — the port's copy of ``paddle_tpu/core/flags.py``
(``define_flag``/``set_flags``/``get_flags``/``flag``), holding the flags
the serving engine reads (``:162-250, 255-420``) and the tracing and
fault-injection flags (``:610-690``). A flag is also read from the
environment as ``FLAGS_<name>`` when it is defined."""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]


@dataclass
class _Flag:
    name: str
    default: Any
    help: str
    on_set: Callable[[Any], None] | None = None
    value: Any = None


_REGISTRY: dict[str, _Flag] = {}
_lock = threading.Lock()


def define_flag(name: str, default: Any, help: str = "",
                on_set: Callable[[Any], None] | None = None) -> None:
    with _lock:
        if name in _REGISTRY:
            raise KeyError(f"flag {name!r} already defined")
        env = os.environ.get(f"FLAGS_{name}")
        value = default if env is None else _coerce(env, default)
        _REGISTRY[name] = _Flag(name, default, help, on_set, value)
    if env is not None and _REGISTRY[name].on_set:
        _REGISTRY[name].on_set(value)


def _coerce(raw: str, default: Any) -> Any:
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def set_flags(flags: dict[str, Any]) -> None:
    """``paddle.set_flags`` equivalent; an unknown name raises
    ``KeyError``."""
    for name, value in flags.items():
        with _lock:
            if name not in _REGISTRY:
                raise KeyError(f"unknown flag {name!r}")
            f = _REGISTRY[name]
            f.value = value
        if f.on_set is not None:
            f.on_set(value)


def get_flags(names: list[str] | str | None = None) -> dict[str, Any]:
    """``paddle.get_flags`` equivalent."""
    if names is None:
        names = list(_REGISTRY)
    if isinstance(names, str):
        names = [names]
    return {n: _REGISTRY[n].value for n in names}


def flag(name: str) -> Any:
    """Fast read of a single flag value."""
    return _REGISTRY[name].value


# --- continuous-batching generation engine (serving/engine.py) ---
define_flag("gen_slots", 0,
            "Slot count of the GenerationEngine: one fixed-shape batched "
            "KV cache (or page table) holds this many concurrent "
            "generations, admitted and retired at decode-step "
            "granularity. 0 — the default — disables generation serving: "
            "an engine then needs an explicit slots=")
define_flag("gen_max_len", 512,
            "Per-slot KV capacity of the GenerationEngine (prompt + "
            "generated tokens); allocated once, so shapes stay static")
define_flag("gen_queue_max", 8,
            "Prompts that may queue for a free slot before start() is "
            "shed with the retryable EngineOverloaded. 0 = unbounded")
define_flag("gen_poll_ttl_s", 30.0,
            "Reap a generation whose client has not polled for this long "
            "(gen/evictions counts the reclaims). <= 0 disables")
define_flag("gen_paged", False,
            "Paged KV-cache mode: a pool of fixed-size pages plus "
            "per-slot page tables instead of contiguous per-slot regions")
define_flag("gen_page_tokens", 16, "Tokens per physical KV page")
define_flag("gen_pages", 0,
            "Physical pages in the paged pool. 0 — the default — sizes "
            "it to gen_slots x ceil(gen_max_len / gen_page_tokens), the "
            "contiguous layout's memory")
define_flag("gen_prefill_chunk", 0,
            "Chunked prefill (paged mode): admit a prompt in slices of "
            "this many tokens, interleaved with decode steps. 0 "
            "prefills the whole prompt (past any shared prefix) at once")
define_flag("gen_prefix_cache", True,
            "Radix prefix cache over full prompt pages (paged mode): "
            "prompts sharing a prefix map it onto the same refcounted "
            "pages and prefill it once")
# engine features this port does not carry yet (their constructor
# arguments raise NotImplementedError when set; see ROADMAP A2c/A2d/A6)
define_flag("gen_quarantine_after", 0, "Crash quarantine threshold")
define_flag("gen_engine_rebuilds", 0, "Engine self-healing budget")
define_flag("gen_watchdog_s", 0.0, "Stuck-step watchdog period")
define_flag("gen_spec_k", 0, "Speculative-decoding draft length")
define_flag("gen_async_depth", 0, "Decode dispatch lookahead depth")
define_flag("gen_mesh_tp", 0, "Tensor-parallel degree of the engine")
define_flag("gen_ledger", False, "Per-request latency ledger")
define_flag("gen_kv_store", False, "Fleet-wide KV page store")
define_flag("gen_role", "both", "Replica serving role")
define_flag("gen_sched", False, "SLO-aware tenant-fair scheduler")


# --- observability and fault injection (core/trace.py, core/fault.py) ---

def _on_trace(v) -> None:
    from paddle_tpu_torch.core import trace

    trace.configure(bool(v))


def _on_trace_buffer(v) -> None:
    from paddle_tpu_torch.core import trace

    if trace.enabled():            # live resize; keeps the newest spans
        trace.configure(True, capacity=int(v))


def _on_fault_seed(v) -> None:
    try:
        spec = flag("fault_inject")
    except KeyError:       # fault_inject is defined right after
        return
    from paddle_tpu_torch.core import fault

    fault.configure(spec, seed=int(v))


def _on_fault_inject(v) -> None:
    from paddle_tpu_torch.core import fault

    fault.configure(v)


# trace_buffer before trace, fault_seed before fault_inject: each on_set
# reads the other when a FLAGS_* environment variable fires it here
define_flag("trace_buffer", 4096,
            "Span ring-buffer capacity of the tracer (core/trace.py)",
            on_set=_on_trace_buffer)
define_flag("trace", False,
            "Record framework spans (the engine's gen/* spans) into an "
            "in-process ring buffer. Hard-off by default",
            on_set=_on_trace)
define_flag("trace_sample", 0,
            "With tracing on, a gen/decode_sample event every Nth token "
            "of a stream that carries a trace id. 0 records none")
define_flag("fault_seed", 0,
            "Seed of the deterministic per-site fault-injection RNGs",
            on_set=_on_fault_seed)
define_flag("fault_inject", "",
            "Fault-injection spec, e.g. 'engine.prefill=1.0@2' "
            "(site=probability, optional @N fire cap). Empty — the "
            "default — disables injection",
            on_set=_on_fault_inject)
