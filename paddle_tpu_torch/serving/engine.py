"""Continuous-batching generation engine — the port of
``paddle_tpu/serving/engine.py``: slot-scheduled decode with streaming
token delivery, over a contiguous per-slot KV cache or a paged pool with a
radix prefix cache and chunked prefill.

- **One fixed-shape batched cache.** The engine owns ``slots`` caches of
  ``max_len`` positions, allocated once: the model's stacked cache with
  the slots as its batch (``[L, slots, Hkv, S, D]``), or, in paged mode,
  a pool of ``pages`` pages of ``page_tokens`` tokens
  (``models.generation.init_paged_cache``) with a device page table
  ``[slots, ceil(max_len / page_tokens)]``.
- **Iteration-level scheduling.** A background loop admits queued prompts
  into free slots (bucketed prefill; in paged mode chunk by chunk,
  interleaved with decode), steps *all* slots through ONE batched decode
  (``forward_with_cache`` of one token a slot at the slots' own
  positions: the JAX engine's ``jax.vmap``, ``engine.py:860-888``), and
  retires slots on EOS, ``max_new_tokens``, cancel or poll-TTL expiry.
  Inactive slots compute too; their token and position stay frozen.
- **The decode step as a CUDA graph.** On a CUDA device the batched step
  is captured once, on the loop thread, and replayed: the counterpart of
  the JAX engine's one compiled fused step. Its inputs are static device
  buffers updated in place before each replay — the slots' tokens,
  positions, the active mask and the page table — and its output is the
  slots' last logits; sampling runs after it, outside the graph. The
  attention kernels read the positions and the page table from device
  memory (``kernels.decode_attention`` per slot,
  ``kernels.paged_decode_attention``), so one graph serves every step.
  Prefill runs eagerly, one bucket (or chunk) at a time.
- **Paged step.** Attention reads each slot's ``[0, pos)`` from its pages
  in place plus the fresh k/v (the paged decode kernel, where the JAX
  engine gathers the pages into a contiguous copy first), then the new
  k/v are scattered to page ``table[pos // P]`` at offset ``pos % P``;
  inactive slots scatter to the null page (``engine.py:923-968``). Paged
  prefill gathers the slot's pages, runs the chunk at its absolute index
  and scatters it back, padding sent to the null page (``:970-1014``).
- **Sampling.** Greedy (``temperature <= 0``) is the row's argmax. A
  sampled request draws token ``k`` from its own device generator
  positioned by ``models.generation.advance_generator(gen, seed,
  rng_skip + k)``: the stream is deterministic per ``(prompt, seed)``
  whatever its co-tenants, and ``rng_skip`` resumes it mid-stream. The
  draws are not the JAX engine's (threefry against Philox).

Determinism: a greedy generation through the engine equals a solo
``models.generation.generate`` call token for token on the CPU in fp32.
On the card in bf16, batched and solo GEMMs may pick other algorithms, so
streams agree up to bf16 rounding.

The JAX engine's speculative decoding and async dispatch (ROADMAP A2c),
its KV store, roles, scheduler, ledger and self-healing (A2d) and its
tensor-parallel mesh (A6) are not ported: their constructor arguments
raise ``NotImplementedError`` when set. A decode-loop error breaks the
engine (the JAX engine's default with self-healing off): every
generation fails with the error and new starts raise.

Observability: ``gen/slots_active`` / ``gen/queue_depth`` /
``gen/pages_free`` gauges, ``gen/prefill_s`` / ``gen/prefill_chunk_s`` /
``gen/decode_step_s`` / ``gen/ttft_s`` histograms, ``gen/tokens`` /
``gen/evictions`` / ``gen/shed`` / ``gen/prefix_hits`` /
``gen/prefix_tokens_saved`` / ``gen/prefix_evictions`` /
``gen/expired_polls`` / ``gen/traps`` counters (``core.monitor``),
``gen/prefill`` + ``gen/prefill_chunk`` + ``gen/decode_step`` spans
(``core.trace``) and the fault sites ``engine.prefill``,
``engine.decode_step`` and ``paged.alloc`` (``core.fault``).
"""

from __future__ import annotations

import random as _random_mod
import threading
import time
import uuid
from collections import deque

import numpy as np
import torch

from paddle_tpu_torch.core import fault as _fault
from paddle_tpu_torch.core import trace as _trace
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.core.monitor import observe, stat_add, stat_set
from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.models._common import PagedKV
from paddle_tpu_torch.models.generation import (advance_generator,
                                                filter_logits,
                                                init_paged_cache,
                                                paged_gather, paged_scatter)

__all__ = ["GenerationEngine", "Generation", "EngineOverloaded",
           "RequestQuarantined", "GenerationExpired", "EXPIRED_MARKER"]

_UNSET = object()

# The prefix of a reaped generation's error, as it crosses a wire
# (``paddle_tpu/serving/engine.py:149``)
EXPIRED_MARKER = "generation expired:"

# private shed-jitter stream: synchronized clients whose starts were all
# shed in the same instant must not retry in the same instant
_jitter_rng = _random_mod.Random()


def _jittered(base: float) -> float:
    """``base`` scaled by U[0.5, 1.5)."""
    return base * (0.5 + _jitter_rng.random())


class EngineOverloaded(RuntimeError):
    """Every slot is busy and the admit queue is full; the request was
    NOT enqueued. Safe to retry after ``retry_after_s``."""

    def __init__(self, msg: str, retry_after_s: float = 0.25):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RequestQuarantined(RuntimeError):
    """A request refused for its crash fingerprint. The port carries no
    quarantine yet (ROADMAP A2d); the type is here for the surface."""

    def __init__(self, msg: str, fingerprint: str = ""):
        super().__init__(msg)
        self.fingerprint = fingerprint


class GenerationExpired(KeyError):
    """The polled generation existed here but was reaped by the poll TTL
    (client presumed disconnected) — distinct from an unknown id."""


class Generation:
    """Host-side record of one generation request. ``tokens`` grows as
    steps emit; ``slot`` is None while queued and again after
    retirement."""

    __slots__ = ("gen_id", "prompt", "max_new_tokens", "temperature",
                 "top_k", "top_p", "eos_token_id", "seed", "tokens",
                 "done", "error", "slot", "created", "last_poll",
                 "pages", "shared", "prefilling", "prefill_pos",
                 "prefill_t0", "delivered", "rng_skip", "trace_id",
                 "generator")

    def __init__(self, gen_id: str, prompt: np.ndarray,
                 max_new_tokens: int, temperature: float, top_k: int,
                 top_p: float, eos_token_id: int | None, seed: int):
        self.gen_id = gen_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.seed = seed
        self.tokens: list[int] = []
        self.done = False
        self.error: str | None = None
        self.slot: int | None = None
        self.created = time.monotonic()
        self.last_poll = self.created
        # a poll response carried done=True with every token
        self.delivered = False
        # paged mode: mapped physical pages (shared prefix first), how
        # many are prefix-cache hits, and the chunked-prefill cursor
        self.pages: list[int] = []
        self.shared = 0
        self.prefilling = False
        self.prefill_pos = 0
        self.prefill_t0 = 0.0
        # tokens a resumed sampled stream delivered before this one
        self.rng_skip = 0
        self.trace_id: str | None = None
        # the request's own device generator (sampled requests only)
        self.generator: torch.Generator | None = None


class _PagePool:
    """Host-side refcounted allocator over the physical page pool
    (``paddle_tpu/serving/engine.py:298-334``). Usable page ids are ``1 ..
    num_pages``; id 0 is the null page. Runs under the engine's lock."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages, 0, -1))   # pop() -> 1 first
        self._ref = [0] * (self.num_pages + 1)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        _fault.inject("paged.alloc")
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, free {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            self._ref[pid] = 1
        return out

    def retain(self, pid: int) -> None:
        self._ref[pid] += 1

    def release(self, pid: int) -> None:
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
        elif self._ref[pid] < 0:        # double free = allocator bug
            raise AssertionError(f"page {pid} refcount underflow")

    def refcount(self, pid: int) -> int:
        return self._ref[pid]


class _PrefixEntry:
    __slots__ = ("key", "page", "parent_page", "children", "last_used")

    def __init__(self, key, page: int, parent_page: int):
        self.key = key
        self.page = page
        self.parent_page = parent_page
        self.children = 0
        self.last_used = 0


class _PrefixCache:
    """Radix cache over FULL prompt pages
    (``paddle_tpu/serving/engine.py:348-437``): entry key = (parent page
    id, the page's token bytes), so two prompts share exactly their
    common whole-page prefix. Only pages a prompt fully covers are
    registered (decode writes start at the prompt's end), and a match
    leaves at least one prompt token to prefill (the first sampled token
    needs its logits). The cache holds its own reference on each page,
    so shared pages outlive their last generation until LRU-evicted
    under pool pressure, leaves first."""

    def __init__(self, page_tokens: int):
        self._P = int(page_tokens)
        self._entries: dict[tuple, _PrefixEntry] = {}
        self._by_page: dict[int, _PrefixEntry] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _touch(self, e: _PrefixEntry) -> None:
        self._clock += 1
        e.last_used = self._clock

    def match(self, prompt: np.ndarray, pool: _PagePool) -> list[int]:
        """Longest cached whole-page prefix of ``prompt``; each matched
        page is retained for the caller."""
        P = self._P
        pages: list[int] = []
        parent = 0
        for i in range((int(prompt.size) - 1) // P):
            e = self._entries.get((parent,
                                   prompt[i * P:(i + 1) * P].tobytes()))
            if e is None:
                break
            self._touch(e)
            pool.retain(e.page)
            pages.append(e.page)
            parent = e.page
        return pages

    def insert(self, prompt: np.ndarray, gen_pages: list[int],
               pool: _PagePool) -> None:
        """Register a finished prefill's full prompt pages; a chain key
        already cached is touched, not replaced."""
        P = self._P
        parent = 0
        for i in range(int(prompt.size) // P):
            key = (parent, prompt[i * P:(i + 1) * P].tobytes())
            e = self._entries.get(key)
            if e is None:
                e = _PrefixEntry(key, gen_pages[i], parent_page=parent)
                self._entries[key] = e
                self._by_page[e.page] = e
                pool.retain(e.page)
                pe = self._by_page.get(parent)
                if pe is not None:
                    pe.children += 1
            self._touch(e)
            parent = e.page

    def evict(self, n: int, pool: _PagePool) -> int:
        """Free up to ``n`` pages by dropping LRU leaf entries that no
        live generation references (page refcount 1 = cache only)."""
        freed = 0
        while freed < n:
            cands = [e for e in self._entries.values()
                     if e.children == 0 and pool.refcount(e.page) == 1]
            if not cands:
                break
            e = min(cands, key=lambda c: c.last_used)
            del self._entries[e.key]
            self._by_page.pop(e.page, None)
            pe = self._by_page.get(e.parent_page)
            if pe is not None:
                pe.children -= 1
            pool.release(e.page)
            freed += 1
        if freed:
            stat_add("gen/prefix_evictions", freed)
        return freed


def _sample_slot(logits, gen: Generation) -> torch.Tensor:
    """The next token of one slot from its [V] logits
    (``paddle_tpu/serving/engine.py:458-483``): the argmax where
    ``temperature <= 0``, else a draw from the temperature / top-k /
    nucleus filtered distribution, with the request's generator at its
    stream offset. Returns a 0-d int64 tensor on the logits' device."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits)
    if gen.generator is None:
        gen.generator = torch.Generator(device=logits.device)
    advance_generator(gen.generator, gen.seed,
                      gen.rng_skip + len(gen.tokens))
    probs = torch.softmax(filter_logits(
        logits[None], temperature=gen.temperature, top_k=gen.top_k,
        top_p=gen.top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=gen.generator)[0, 0]


def _refuse(name: str, value, item: str) -> None:
    raise NotImplementedError(
        f"GenerationEngine({name}={value!r}): not ported yet (ROADMAP "
        f"{item})")


class GenerationEngine:
    """Slot-scheduled continuous-batching decode over one model.

    ``model`` is an attention-family model of the port (``init_cache(B,
    S, dtype=...)`` with the stacked ``[L, B, Hkv, S, ...]`` layout and
    ``forward_with_cache(ids, cache, index)`` taking a per-slot index:
    Llama, GPT). ``slots`` defaults to ``FLAGS_gen_slots`` (0 = serving
    disabled: constructing without ``slots`` raises); ``max_len`` /
    ``queue_max`` / ``ttl_s`` default to ``FLAGS_gen_max_len`` /
    ``gen_queue_max`` / ``gen_poll_ttl_s``, ``max_len`` capped by the
    model's ``max_seq_len``. ``paged`` / ``page_tokens`` / ``pages`` /
    ``prefill_chunk`` / ``prefix_cache`` default to the ``gen_paged`` /
    ``gen_page_tokens`` / ``gen_pages`` / ``gen_prefill_chunk`` /
    ``gen_prefix_cache`` flags. ``cache_dtype`` goes to ``init_cache``
    (``torch.int8`` is the quantized cache: the contiguous engine's decode
    kernel takes it; the paged pool's kernel is float only, and a paged
    int8 engine on the card raises at its first step).

    The background loop starts on construction; :meth:`close` retires it.
    Only the loop thread touches the device; :meth:`start` /
    :meth:`poll` / :meth:`cancel` / :meth:`stats` are host-side and
    lock-guarded.
    """

    def __init__(self, model, *, slots: int | None = None,
                 max_len: int | None = None, queue_max: int | None = None,
                 ttl_s: float | None = None, eos_token_id: int | None = None,
                 pad_token_id: int = 0, cache_dtype=None,
                 min_bucket: int = 8, step_wait_s: float = 0.0,
                 paged: bool | None = None, page_tokens: int | None = None,
                 pages: int | None = None, prefill_chunk: int | None = None,
                 prefix_cache: bool | None = None,
                 quarantine_after: int | None = None,
                 rebuilds: int | None = None,
                 watchdog_s: float | None = None,
                 spec_k: int | None = None, spec_mode: str | None = None,
                 draft_model=None, spec_ngram: int | None = None,
                 spec_shed_occupancy: float | None = None,
                 mesh_tp: int | None = None, ledger=None,
                 kv_store=None, role: str | None = None,
                 device_pt: bool | None = None,
                 async_depth: int | None = None,
                 sched=None):
        def read(value, name):
            return flag(name) if value is None else value

        for name, value, item in (
                ("spec_k", int(read(spec_k, "gen_spec_k")), "A2c"),
                ("async_depth", int(read(async_depth, "gen_async_depth")),
                 "A2c"),
                ("quarantine_after",
                 int(read(quarantine_after, "gen_quarantine_after")), "A2d"),
                ("rebuilds", int(read(rebuilds, "gen_engine_rebuilds")),
                 "A2d"),
                ("watchdog_s", float(read(watchdog_s, "gen_watchdog_s")),
                 "A2d"),
                ("mesh_tp", int(read(mesh_tp, "gen_mesh_tp")), "A6")):
            if value > 0:
                _refuse(name, value, item)
        if draft_model is not None:
            _refuse("draft_model", draft_model, "A2c")
        for name, value, fname in (("ledger", ledger, "gen_ledger"),
                                   ("kv_store", kv_store, "gen_kv_store"),
                                   ("sched", sched, "gen_sched")):
            if read(value, fname):
                _refuse(name, value, "A2d")
        if str(read(role, "gen_role")) != "both":
            _refuse("role", role, "A2d")
        del spec_mode, spec_ngram, spec_shed_occupancy, device_pt

        slots = int(read(slots, "gen_slots"))
        if slots <= 0:
            raise ValueError(
                "generation serving is disabled (FLAGS_gen_slots=0); set "
                "the flag or pass slots= explicitly")
        self.slots = slots
        self.max_len = int(read(max_len, "gen_max_len"))
        cfg_max = getattr(getattr(model, "config", None), "max_seq_len",
                          None)
        if cfg_max is not None:
            self.max_len = min(self.max_len, int(cfg_max))
        self._queue_max = int(read(queue_max, "gen_queue_max"))
        self._ttl_s = float(read(ttl_s, "gen_poll_ttl_s"))
        self._eos_default = eos_token_id
        self._pad = int(pad_token_id)
        self._min_bucket = max(int(min_bucket), 1)
        # pacing knob: minimum gap between decode steps (tests and
        # chaos checks use it to make scheduling windows visible)
        self.step_wait_s = float(step_wait_s)
        self._model = model
        self._device = model.device
        self._cache_dtype = cache_dtype
        self._paged = bool(read(paged, "gen_paged"))
        self._prefill_chunk = int(read(prefill_chunk, "gen_prefill_chunk"))

        if self._paged:
            P = int(read(page_tokens, "gen_page_tokens"))
            if P < 1:
                raise ValueError(f"page_tokens must be >= 1, got {P}")
            self._page_tokens = P
            self._maxp = -(-self.max_len // P)       # pages per table row
            npages = int(read(pages, "gen_pages"))
            if npages <= 0:                # the contiguous layout's memory
                npages = self.slots * self._maxp
            self._pool = _PagePool(npages)
            self._prefix = (_PrefixCache(P)
                            if read(prefix_cache, "gen_prefix_cache")
                            else None)
            # host page tables, the scheduler's truth (0 = null page;
            # rows zero while the slot is free), mirrored to the device
            # buffer before each step
            self._pt = np.zeros((self.slots, self._maxp), np.int32)
            stat_set("gen/pages_free", self._pool.free_count)
            proto = model.init_cache(1, self.max_len, dtype=cache_dtype)
            self._cache = init_paged_cache(proto, npages, P)
            del proto
        else:
            self._pool = self._prefix = self._pt = None
            self._cache = model.init_cache(self.slots, self.max_len,
                                           dtype=cache_dtype)
        # the slots' decode inputs on the host (the source of truth) and
        # the static device buffers the step reads, refreshed in place
        # before each step (a captured graph reads them by address)
        self._tok = np.zeros((self.slots,), np.int64)
        self._pos = np.zeros((self.slots,), np.int32)
        dev = self._device
        self._tok_buf = torch.zeros((self.slots, 1), dtype=torch.long,
                                    device=dev)
        self._pos_buf = torch.zeros((self.slots,), dtype=torch.int32,
                                    device=dev)
        self._active_buf = torch.zeros((self.slots,), dtype=torch.bool,
                                       device=dev)
        self._pt_buf = (torch.zeros((self.slots, self._maxp),
                                    dtype=torch.int32, device=dev)
                        if self._paged else None)
        self._use_graph = dev.type == "cuda"
        self._graph: torch.cuda.CUDAGraph | None = None
        self._graph_logits: torch.Tensor | None = None
        self._graph_launches: dict[str, int] = {}
        # device work done, for stats() (and a path's exact launch counts):
        # batched steps, prefill forwards, and those of them at index 0
        self.decode_steps = 0
        self.prefill_calls = 0
        self.prefill_calls_fresh = 0

        self._cond = threading.Condition()
        self._queue: deque[Generation] = deque()
        self._slot_gen: list[Generation | None] = [None] * self.slots
        self._gens: dict[str, Generation] = {}
        self._expired: dict[str, float] = {}
        self._stopping = False
        self._broken: str | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gen-engine")
        self._thread.start()

    # -- public surface ----------------------------------------------------
    def start(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
              top_k: int = 0, top_p: float = 1.0, eos_token_id=_UNSET,
              seed: int = 0, rng_skip: int = 0,
              trace_id: str | None = None) -> str:
        """Enqueue a generation; returns its id at once. Raises
        :class:`EngineOverloaded` (retryable) when every slot is busy and
        the queue is at ``queue_max``. ``rng_skip`` starts a sampled
        stream that many tokens in (a resumed stream's position; greedy
        requests ignore it). ``trace_id`` is the caller's stream trace
        id: with tracing on, the generation's lifecycle events record
        under it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rng_skip = int(rng_skip)
        if rng_skip < 0:
            raise ValueError("rng_skip must be >= 0")
        reserve = prompt.size + max_new_tokens
        if reserve > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's per-slot "
                f"capacity ({self.max_len}); raise FLAGS_gen_max_len")
        if self._paged:
            need = -(-reserve // self._page_tokens)
            if need > self._pool.num_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self._pool.num_pages}; raise FLAGS_gen_pages")
        eos = self._eos_default if eos_token_id is _UNSET else eos_token_id
        gen = Generation(uuid.uuid4().hex[:16], prompt, max_new_tokens,
                         float(temperature), int(top_k), float(top_p),
                         None if eos is None else int(eos), int(seed))
        gen.rng_skip = rng_skip
        if trace_id:
            gen.trace_id = str(trace_id)
        with self._cond:
            if self._stopping:
                raise RuntimeError("GenerationEngine is stopped")
            if self._broken is not None:
                raise RuntimeError(
                    f"GenerationEngine is broken: {self._broken}")
            free = sum(g is None for g in self._slot_gen)
            pending = len(self._queue) - free
            if self._queue_max > 0 and pending >= self._queue_max:
                stat_add("gen/shed")
                pool = ("" if not self._paged else
                        f", {self._pool.free_count}/"
                        f"{self._pool.num_pages} pages free")
                raise EngineOverloaded(
                    f"engine full: {self.slots} slots busy, "
                    f"{len(self._queue)} queued (queue_max="
                    f"{self._queue_max}){pool}",
                    retry_after_s=_jittered(0.25))
            self._queue.append(gen)
            self._gens[gen.gen_id] = gen
            stat_set("gen/queue_depth", len(self._queue))
            self._cond.notify_all()
        return gen.gen_id

    def poll(self, gen_id: str, start: int = 0,
             wait_s: float = 0.0) -> dict:
        """Tokens past ``start``; blocks up to ``wait_s`` for new ones.
        Returns ``{"tokens", "done", "error", "queued"}``. Polling
        refreshes the generation's TTL."""
        start = max(int(start), 0)
        deadline = time.monotonic() + max(float(wait_s), 0.0)
        with self._cond:
            gen = self._gens.get(gen_id)
            if gen is None:
                if gen_id in self._expired:
                    stat_add("gen/expired_polls")
                    raise GenerationExpired(
                        f"{EXPIRED_MARKER} generation {gen_id} was "
                        "reaped by the poll TTL (client presumed "
                        "disconnected); restart it")
                raise KeyError(f"unknown generation {gen_id!r} "
                               "(finished long ago, evicted, or never "
                               "started here)")
            gen.last_poll = time.monotonic()
            while (not gen.done and len(gen.tokens) <= start
                   and not self._stopping):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                gen.last_poll = time.monotonic()
            if gen.done:
                gen.delivered = True
            return {"tokens": list(gen.tokens[start:]), "done": gen.done,
                    "error": gen.error,
                    "queued": gen.slot is None and not gen.done}

    def cancel(self, gen_id: str) -> bool:
        """Cancel a generation and free its slot (idempotent; unknown ids
        return False)."""
        with self._cond:
            gen = self._gens.pop(gen_id, None)
            if gen is None:
                return False
            if not gen.done:
                gen.done = True
                gen.error = gen.error or "cancelled"
                self._release_slot_locked(gen, evicted=True)
                try:
                    self._queue.remove(gen)
                except ValueError:
                    pass
                stat_set("gen/queue_depth", len(self._queue))
                self._gen_event(gen, "gen/retire", reason="cancelled",
                                tokens=len(gen.tokens))
            self._cond.notify_all()
        return True

    def stats(self) -> dict:
        """Slot and page-pool occupancy snapshot."""
        with self._cond:
            active = sum(g is not None for g in self._slot_gen)
            doc = {"slots": self.slots, "active": active,
                   "free": self.slots - active,
                   "queued": len(self._queue),
                   "generations": len(self._gens),
                   "undelivered": sum(
                       1 for g in self._gens.values()
                       if not (g.done and g.delivered)),
                   "max_len": self.max_len,
                   "broken": self._broken,
                   "paged": self._paged,
                   "decode_steps": self.decode_steps,
                   "prefill_calls": self.prefill_calls,
                   "prefill_calls_fresh": self.prefill_calls_fresh,
                   "cuda_graph": self._graph is not None,
                   "device": str(self._device)}
            if self._paged:
                doc.update(
                    page_tokens=self._page_tokens,
                    pages=self._pool.num_pages,
                    pages_free=self._pool.free_count,
                    prefix_entries=(0 if self._prefix is None
                                    else len(self._prefix)))
            return doc

    def clear_prefix_cache(self) -> int:
        """Drop every prefix-cache entry no live generation references.
        Returns the pages freed."""
        with self._cond:
            if self._prefix is None:
                return 0
            freed = self._prefix.evict(self._pool.num_pages, self._pool)
            stat_set("gen/pages_free", self._pool.free_count)
            return freed

    def close(self) -> None:
        """Stop the loop; error out queued and active generations."""
        with self._cond:
            if self._stopping:
                return
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout=30.0)
        with self._cond:
            for gen in list(self._gens.values()):
                if not gen.done:
                    gen.done = True
                    gen.error = gen.error or "engine stopped"
                    gen.slot = None
                    self._gen_event(gen, "gen/retire", reason="stopped",
                                    tokens=len(gen.tokens))
                gen.pages = []
            self._slot_gen = [None] * self.slots
            self._queue.clear()
            if self._paged:
                self._pt[:] = 0
            self._cond.notify_all()
        # a closed engine runs no more steps: its captured graph (and the
        # memory pool it holds) goes
        self._graph = self._graph_logits = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- tracing -------------------------------------------------------------
    def _gen_span(self, gen: Generation, name: str, **attrs):
        """A span for per-generation work, under the stream's trace id
        when it carries one; the shared no-op while tracing is off."""
        if _trace._ACTIVE is None:
            return _trace._NOOP
        if gen.trace_id is not None:
            return _trace.span(name, trace_id=gen.trace_id, gen=gen.gen_id,
                               **attrs)
        return _trace.span(name, **attrs)

    def _gen_event(self, gen: Generation, name: str, **attrs) -> None:
        """A zero-length lifecycle event under the stream's trace id (a
        no-op unless tracing is on and the stream carries an id)."""
        if _trace._ACTIVE is None or gen.trace_id is None:
            return
        with _trace.span(name, trace_id=gen.trace_id, gen=gen.gen_id,
                         **attrs):
            pass

    # -- scheduler loop ----------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stopping:
                    return
                if (not self._queue
                        and not any(g is not None for g in self._slot_gen)):
                    # idle: wake on new work, and every 0.25 s anyway so
                    # that TTL reaping runs while nothing streams
                    self._cond.wait(timeout=0.25)
                    if self._stopping:
                        return
            try:
                self._reap_expired()
                if self._paged:
                    progressed = self._admit_paged()
                    progressed |= self._prefill_tick()
                    progressed |= self._decode_step()
                    if not progressed:
                        # the queue waits on pages and nothing steps:
                        # wait for a cancel/TTL/poll instead of spinning
                        with self._cond:
                            if not self._stopping:
                                self._cond.wait(timeout=0.05)
                else:
                    self._admit()
                    self._decode_step()
            except Exception as e:   # a device-side failure: fail loudly
                stat_add("gen/traps")
                self._break(e)
                return

    def _break(self, e: Exception) -> None:
        msg = f"{type(e).__name__}: {e}"
        with self._cond:
            self._broken = msg
            for gen in list(self._gens.values()):
                if not gen.done:
                    gen.done = True
                    gen.error = msg
                    gen.slot = None
                    self._gen_event(gen, "gen/retire", reason="broken",
                                    tokens=len(gen.tokens))
                gen.pages = []
            self._slot_gen = [None] * self.slots
            self._queue.clear()
            if self._paged:
                self._pt[:] = 0
                self._pool = _PagePool(self._pool.num_pages)
                if self._prefix is not None:
                    self._prefix = _PrefixCache(self._page_tokens)
            self._cond.notify_all()

    def _release_slot_locked(self, gen: Generation,
                             evicted: bool = False) -> None:
        if gen.slot is not None and self._slot_gen[gen.slot] is gen:
            self._slot_gen[gen.slot] = None
            if self._paged:
                self._pt[gen.slot] = 0
            if evicted:
                stat_add("gen/evictions")
        if self._paged and gen.pages:
            # pages the prefix cache also holds stay allocated
            for pid in gen.pages:
                self._pool.release(pid)
            gen.pages = []
            stat_set("gen/pages_free", self._pool.free_count)
        gen.slot = None
        gen.prefilling = False
        stat_set("gen/slots_active",
                 sum(g is not None for g in self._slot_gen))

    def _reap_expired(self) -> None:
        if self._ttl_s <= 0:
            return
        now = time.monotonic()
        with self._cond:
            expired = [g for g in self._gens.values()
                       if now - max(g.created, g.last_poll) > self._ttl_s]
            for g in expired:
                self._gens.pop(g.gen_id, None)
                self._expired[g.gen_id] = now
                while len(self._expired) > 256:     # oldest first
                    self._expired.pop(next(iter(self._expired)))
                if not g.done:
                    g.done = True
                    g.error = (f"{EXPIRED_MARKER} poll TTL exceeded "
                               "(client gone?)")
                    self._gen_event(g, "gen/retire", reason="expired",
                                    tokens=len(g.tokens))
                    self._release_slot_locked(g, evicted=True)
                    try:
                        self._queue.remove(g)
                    except ValueError:
                        pass
            if expired:
                self._cond.notify_all()

    def _bucket(self, n: int) -> int:
        b = self._min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _admit_locked(self, gen: Generation, slot: int) -> None:
        self._slot_gen[slot] = gen
        gen.slot = slot
        stat_set("gen/slots_active",
                 sum(g is not None for g in self._slot_gen))

    def _admit(self) -> None:
        """Contiguous mode: pop queued prompts into free slots and
        prefill each at once."""
        while True:
            with self._cond:
                free = [s for s, g in enumerate(self._slot_gen)
                        if g is None]
                if not free or not self._queue:
                    stat_set("gen/queue_depth", len(self._queue))
                    return
                gen = self._queue.popleft()
                if gen.done:          # cancelled while queued
                    continue
                slot = free[0]
                self._admit_locked(gen, slot)
                self._gen_event(gen, "gen/admitted", slot=slot,
                                prompt_len=int(gen.prompt.size))
            self._prefill(gen, slot)

    def _admit_paged(self) -> bool:
        """Paged mode: assign free slots and page reservations to queued
        prompts in FIFO order (``paddle_tpu/serving/engine.py:2039-2144``).
        A generation reserves pages for its declared worst case (prompt +
        max_new_tokens) less the whole-page prefix the radix cache already
        holds; when the pool cannot cover the queue's head even after
        evicting unreferenced cached pages, admission waits. Prefill then
        runs chunk by chunk in :meth:`_prefill_tick`."""
        progressed = False
        while True:
            with self._cond:
                free = [s for s, g in enumerate(self._slot_gen)
                        if g is None]
                if not free or not self._queue:
                    stat_set("gen/queue_depth", len(self._queue))
                    return progressed
                gen = self._queue[0]
                if gen.done:                # cancelled while queued
                    self._queue.popleft()
                    continue
                P = self._page_tokens
                need = -(-(gen.prompt.size + gen.max_new_tokens) // P)
                matched: list[int] = []
                if self._prefix is not None:
                    matched = self._prefix.match(gen.prompt, self._pool)
                short = (need - len(matched)) - self._pool.free_count
                if short > 0 and self._prefix is not None:
                    self._prefix.evict(short, self._pool)
                if need - len(matched) > self._pool.free_count:
                    for pid in matched:     # give the hits back; retry
                        self._pool.release(pid)   # when pages free up
                    stat_set("gen/queue_depth", len(self._queue))
                    stat_set("gen/pages_free", self._pool.free_count)
                    return progressed
                self._queue.popleft()
                gen.pages = matched + self._pool.alloc(need - len(matched))
                gen.shared = len(matched)
                slot = free[0]
                self._admit_locked(gen, slot)
                gen.prefilling = True
                gen.prefill_pos = len(matched) * P
                gen.prefill_t0 = time.perf_counter()
                self._pt[slot] = 0
                self._pt[slot, :len(gen.pages)] = gen.pages
                if matched:
                    stat_add("gen/prefix_hits")
                    stat_add("gen/prefix_tokens_saved", len(matched) * P)
                stat_set("gen/pages_free", self._pool.free_count)
                stat_set("gen/queue_depth", len(self._queue))
                self._gen_event(gen, "gen/admitted", slot=slot,
                                prompt_len=int(gen.prompt.size),
                                pages=len(gen.pages), shared=gen.shared)
                progressed = True

    def _emit_first(self, gen: Generation, slot: int, tok0: int) -> None:
        """Deliver a finished prefill's first token (lock held)."""
        gen.tokens.append(tok0)
        self._tok[slot] = tok0
        observe("gen/ttft_s", time.monotonic() - gen.created)
        stat_add("gen/tokens")
        if ((gen.eos_token_id is not None and tok0 == gen.eos_token_id)
                or len(gen.tokens) >= gen.max_new_tokens):
            gen.done = True
            self._gen_event(gen, "gen/retire", reason="complete",
                            tokens=len(gen.tokens))
            self._release_slot_locked(gen)
        self._cond.notify_all()

    def _ids(self, gen: Generation, a: int, b: int, bucket: int):
        """Prompt tokens ``[a, b)`` right-padded to ``bucket``, [1, bucket]
        on the device."""
        padded = np.full((bucket,), self._pad, np.int64)
        padded[:b - a] = gen.prompt[a:b]
        return torch.from_numpy(padded)[None].to(self._device)

    @torch.no_grad()
    def _prefill(self, gen: Generation, slot: int) -> None:
        """Contiguous mode: the whole prompt, right-padded to its bucket,
        at index 0 into the slot's region of the batched cache (written in
        place through a view); the first token from the last real
        position's logits."""
        T0 = gen.prompt.size
        bucket = self._bucket(T0)
        t0 = time.perf_counter()
        with self._gen_span(gen, "gen/prefill", slot=slot, prompt_len=T0,
                            bucket=bucket):
            _fault.inject("engine.prefill")
            view = tuple(c[:, slot:slot + 1] for c in self._cache)
            logits, _ = self._model.forward_with_cache(
                self._ids(gen, 0, T0, bucket), view, 0)
            tok0 = int(_sample_slot(logits[0, T0 - 1], gen))
        self.prefill_calls += 1
        self.prefill_calls_fresh += 1
        observe("gen/prefill_s", time.perf_counter() - t0)
        with self._cond:
            if self._slot_gen[slot] is not gen:   # cancelled mid-prefill
                return
            self._pos[slot] = T0
            self._emit_first(gen, slot, tok0)

    @torch.no_grad()
    def _prefill_tick(self) -> bool:
        """Paged mode: advance every prefilling slot by ONE chunk — the
        slot's pages gathered into a contiguous view, the chunk forwarded
        at its absolute index against the prefix already in them, its
        positions scattered back with the padding sent to the null page.
        The final chunk samples the first token and turns the slot over
        to decode."""
        with self._cond:
            work = [(s, g, torch.from_numpy(self._pt[s].copy()))
                    for s, g in enumerate(self._slot_gen)
                    if g is not None and g.prefilling]
        for slot, gen, row in work:
            T0 = gen.prompt.size
            a = gen.prefill_pos
            C = self._prefill_chunk if self._prefill_chunk > 0 else T0 - a
            b = min(T0, a + C)
            final = b >= T0
            # the padded window stays inside the table's reach
            bucket = min(self._bucket(b - a),
                         self._maxp * self._page_tokens - a)
            row = row.to(self._device)
            t0 = time.perf_counter()
            with self._gen_span(gen, "gen/prefill_chunk", slot=slot,
                                index=a, tokens=b - a, final=final):
                _fault.inject("engine.prefill")
                view = paged_gather(self._cache, row)
                logits, view = self._model.forward_with_cache(
                    self._ids(gen, a, b, bucket), view, a)
                chunk = tuple(c[:, :, :, a:a + bucket] for c in view)
                paged_scatter(self._cache, row, chunk, a,
                              self._page_tokens, length=b - a)
                tok0 = (int(_sample_slot(logits[0, b - a - 1], gen))
                        if final else None)
                del view, chunk, logits
            self.prefill_calls += 1
            self.prefill_calls_fresh += a == 0
            observe("gen/prefill_chunk_s", time.perf_counter() - t0)
            with self._cond:
                if self._slot_gen[slot] is not gen:
                    continue                # cancelled/reaped mid-chunk
                gen.prefill_pos = b
                if not final:
                    continue
                gen.prefilling = False
                observe("gen/prefill_s",
                        time.perf_counter() - gen.prefill_t0)
                if self._prefix is not None:
                    self._prefix.insert(gen.prompt, gen.pages, self._pool)
                self._pos[slot] = T0
                self._emit_first(gen, slot, tok0)
        return bool(work)

    # -- the batched decode step --------------------------------------------
    def _step_logits(self):
        """The batched step on the static buffers: one token a slot at the
        slots' positions through ``forward_with_cache`` (the stacked cache
        at a per-slot index, or the pool through ``PagedKV``); returns the
        slots' logits [slots, V]. What a CUDA graph captures."""
        cache = (PagedKV(self._cache, self._pt_buf, self._active_buf)
                 if self._paged else self._cache)
        logits, _ = self._model.forward_with_cache(self._tok_buf, cache,
                                                   self._pos_buf)
        return logits[:, -1]

    @torch.no_grad()
    def _run_step(self):
        """One batched step: eager off the card; on the card the graph,
        captured at the first step (warm-up on a side stream first, as
        capture requires; the step is idempotent for given inputs, so
        the warm-up's cache writes are the ones the replay writes). Each
        replay books the launches the capture recorded."""
        if not self._use_graph:
            return self._step_logits()
        if self._graph is None:
            side = torch.cuda.Stream(self._device)
            side.wait_stream(torch.cuda.current_stream(self._device))
            with torch.cuda.stream(side):
                self._step_logits()
            torch.cuda.current_stream(self._device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with _support.captured_launches() as counts, \
                    torch.cuda.graph(graph):
                self._graph_logits = self._step_logits()
            self._graph, self._graph_launches = graph, counts
        self.replay()
        return self._graph_logits

    def replay(self) -> None:
        """Replay the captured decode step on the static buffers as they
        stand (the loop's step; also a timing hook for a drained
        engine)."""
        self._graph.replay()
        _support.add_launches(self._graph_launches)

    @torch.no_grad()
    def _decode_step(self) -> bool:
        with self._cond:
            stepped = [(s, g) for s, g in enumerate(self._slot_gen)
                       if g is not None and not g.prefilling]
            if not stepped:
                return False
            active = np.zeros((self.slots,), bool)
            for s, _ in stepped:
                active[s] = True
            tok, pos = self._tok.copy(), self._pos.copy()
            table = None if not self._paged else self._pt.copy()
        t0 = time.perf_counter()
        with _trace.span("gen/decode_step", active=len(stepped)):
            _fault.inject("engine.decode_step")
            self._tok_buf.copy_(torch.from_numpy(tok)[:, None])
            self._pos_buf.copy_(torch.from_numpy(pos))
            self._active_buf.copy_(torch.from_numpy(active))
            if table is not None:
                self._pt_buf.copy_(torch.from_numpy(table))
            logits = self._run_step()
            picks = torch.argmax(logits, dim=-1)
            sampled = [(s, g) for s, g in stepped if g.temperature > 0.0]
            if sampled:
                picks = picks.clone()
                for s, g in sampled:
                    picks[s] = _sample_slot(logits[s], g)
            new = picks.tolist()
        observe("gen/decode_step_s", time.perf_counter() - t0)
        sample_n = (int(flag("trace_sample"))
                    if _trace._ACTIVE is not None else 0)
        with self._cond:
            self.decode_steps += 1
            emitted = 0
            for s, gen in stepped:
                if self._slot_gen[s] is not gen:   # cancelled mid-step
                    continue
                t = int(new[s])
                self._tok[s] = t
                self._pos[s] += 1
                gen.tokens.append(t)
                emitted += 1
                if sample_n > 0 and len(gen.tokens) % sample_n == 0:
                    self._gen_event(gen, "gen/decode_sample", slot=s,
                                    token_index=len(gen.tokens))
                if ((gen.eos_token_id is not None
                     and t == gen.eos_token_id)
                        or len(gen.tokens) >= gen.max_new_tokens):
                    gen.done = True
                    self._gen_event(gen, "gen/retire", reason="complete",
                                    tokens=len(gen.tokens))
                    self._release_slot_locked(gen)
            if emitted:
                stat_add("gen/tokens", emitted)
            self._cond.notify_all()
        if self.step_wait_s > 0:
            time.sleep(self.step_wait_s)
        return True
