"""Iteration-level scheduler of `serve`, the host half (port of
`incubator_mxnet_tpu/serve/scheduler.py`: `QueueFull`,
`DeadlineExceeded`, `EngineClosed` :102-117, `Request` :120, `Scheduler`
:254, its speculative round `_spec_decode_once` :666, `preempt` :793 and
the disaggregation hand-off :856-974).

Continuous batching over the paged engine: the unit of scheduling is one
decode step, and prefill is chunked. Every `Scheduler.step`, inside a
``serve.step`` span:

0. fires the ``serve_step`` fault seam (``MXNET_FAULT_INJECT`` chaos) and
   accrues the occupied slots' KV page-seconds to the capacity ledger;
1. expires requests past their deadline (queued, prefilling and
   decoding);
2. admits waiting requests into free slots: the prefix cache is probed
   for a shared page-aligned prompt prefix (its pages attached
   read-only, ``mx_serve_prefix_hits_total``), and the pages for the rest
   of the request are allocated up front, so decode never runs out of
   pages mid-flight;
3. runs one prefill chunk for every prefilling slot
   (``mx_serve_prefill_chunks_total``); the final chunk samples the
   request's first token (time to first token is measured here), flips
   the slot to decoding and registers the prompt's full pages in the
   prefix cache;
4. runs one batched decode step over all decoding slots, or with
   speculative decoding armed one round: the pages of the verify window
   are mapped, ``k`` tokens drafted (host n-gram or the draft step),
   all ``k + 1`` rows verified in one target pass, and the longest
   drafted prefix that matches the target's own tokens accepted, plus
   the target's token after it (none after a full accept with a model
   draft: the draft pool holds no K/V for its own last draft); pages
   mapped for rejected positions roll back at once;
5. retires slots whose request hit EOS or its token budget: pages are
   dereferenced (shared pages survive in the cache) and the slot is free
   at once;
6. refreshes the queue-depth and slot-occupancy gauges.

Every request carries one trace: its ``serve.request`` root span opens at
``submit`` (joining the gateway's trace when ``parent_span`` is given) and
closes when it retires, with ``serve.queue``, ``serve.prefill`` and
``serve.decode`` children. The prefill chunks and the decode step (or the
speculative round's ``serve.spec_draft`` and ``serve.spec_verify``) are
timed for the capacity and anatomy ledgers when either is armed; each
window closes after the step's tokens reached the host, so on the card it
is the step's time, not its launch's. A ``prefill_only`` request (the
disaggregated plane's first stage) frees its slot when its first token is
sampled and keeps its page references for the migration plane
(`take_prefilled`); `adopt` admits a request prefilled elsewhere straight
into decoding.

Admission policies: ``"fifo"`` and ``"sjf"``, which orders by remaining
prefill chunks (a long prompt whose prefix is cached is cheaper than a
shorter cold one), prompt length breaking ties. Admission is page-aware:
a request the pool cannot cover, even after dropping unused prefix-cache
entries, stays queued until running requests retire. Under speculative
decoding a request holds only its prompt's pages and its first decode
page at admission; the rest of its worst case is a reservation
(``Request.spec_reserved``) counted against later admissions, so
``free_pages >= reserved`` always holds and a round's page extension
cannot fail. `Scheduler.preempt` evicts a request without finishing it,
its page-aligned resident prefix kept in the prefix cache for a warm
resubmission. Backpressure is
loud: a full queue raises `QueueFull` at ``submit``, an expired deadline
fails the request with `DeadlineExceeded` (a ``TimeoutError``).

All mutable slot state (``pos``, ``last``, ``active``, page tables) is
host numpy passed into the engine's step, so the loop never branches on
device values; the one device-to-host sync a step is the token fetch.
Step keys are the engine seed's Philox key folded with a step counter
(`ops._philox`), where the reference folds its counter into
``PRNGKey(seed)``.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import time

import numpy as onp

from ..ops import _philox
from ..telemetry import anatomy, capacity, registry, tracing
from .engine import PagePoolExhausted, SlotDecoder

__all__ = ["QueueFull", "DeadlineExceeded", "EngineClosed", "Request",
           "Scheduler", "POLICIES", "TTFT", "TOKENS", "QUEUE_DEPTH",
           "SLOT_OCCUPANCY", "EVICTIONS", "PREFIX_HITS", "PREFILL_CHUNKS",
           "SPEC_DRAFTED", "SPEC_ACCEPTED"]

POLICIES = ("fifo", "sjf")

TTFT = registry.histogram(
    "mx_serve_ttft_seconds",
    "time-to-first-token: submit() to the final prefill chunk's sampled "
    "token")
TOKENS = registry.counter(
    "mx_serve_tokens_total", "tokens generated by the serving engine")
QUEUE_DEPTH = registry.gauge(
    "mx_serve_queue_depth", "requests waiting for a slot")
SLOT_OCCUPANCY = registry.gauge(
    "mx_serve_slot_occupancy",
    "fraction of slots occupied (prefilling + decoding) [0, 1]")
EVICTIONS = registry.counter(
    "mx_serve_evictions_total",
    "slots freed (EOS / length / deadline / shutdown)")
PREFIX_HITS = registry.counter(
    "mx_serve_prefix_hits_total",
    "admissions that reused shared-prefix KV pages from the cache")
PREFIX_TOKENS = registry.counter(
    "mx_serve_prefix_tokens_total",
    "prompt tokens whose prefill was skipped via shared-prefix reuse")
PREFILL_CHUNKS = registry.counter(
    "mx_serve_prefill_chunks_total",
    "prefill chunks executed (long prompts span several, interleaved "
    "with decode steps)")
SPEC_DRAFTED = registry.counter(
    "mx_serve_spec_drafted_tokens_total",
    "draft tokens proposed to the verify program (speculative decoding)")
SPEC_ACCEPTED = registry.counter(
    "mx_serve_spec_accepted_tokens_total",
    "draft tokens accepted by the verify program (speculative decoding)")

_MASK32 = 0xFFFFFFFF


class QueueFull(RuntimeError):
    """Admission queue at capacity: loud backpressure, nothing is silently
    dropped."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it finished (queued or
    mid-decode)."""


class EngineClosed(RuntimeError):
    """The engine is shut down (or draining) and rejects new work."""


_DONE = object()          # stream sentinel
_NULL = tracing._NULL_SPAN   # default for closed-span pops in _trace_close


class Request:
    """One in-flight generation request, also the user's handle.

    Tokens stream into ``_stream`` as they are produced; ``wait()`` blocks
    until completion; ``result()`` returns the generated tokens, raising
    the request's error if it failed."""

    __slots__ = ("id", "prompt", "max_new", "temperature", "eos_id",
                 "deadline", "submit_t", "first_token_t", "finish_t",
                 "tokens", "state", "error", "error_class", "slot",
                 "pages", "shared_tokens", "prefill_pos", "chunks_done",
                 "spec_reserved", "tenant", "prefill_only", "first_token",
                 "anatomy", "trace_id", "_spans", "_stream", "_done")

    def __init__(self, rid, prompt, max_new, temperature, eos_id,
                 deadline, parent_span=None, tenant=None):
        self.id = rid
        self.tenant = tenant              # cost-ledger attribution
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.eos_id = eos_id
        self.deadline = deadline          # absolute monotonic, or None
        self.submit_t = None
        self.first_token_t = None
        self.finish_t = None
        self.tokens = []
        # queued|running|done|failed|preempted|prefilled|migrated
        self.state = "queued"
        self.error = None
        self.error_class = None           # fault.retry's classification
        self.slot = None
        self.pages = None                 # KV pool pages mapped at admit
        self.shared_tokens = 0            # prefix tokens reused from cache
        self.prefill_pos = 0              # prompt tokens already in cache
        self.chunks_done = 0
        self.spec_reserved = 0            # budgeted, not yet allocated pages
        self.prefill_only = False         # disaggregation's first stage
        self.first_token = None           # sampled on the prefill side
        self.anatomy = None               # the latency-anatomy record
        # one trace a request: the root opens at submit on the client's
        # thread and closes at retirement on whichever thread steps; with
        # ``parent_span`` (the gateway's root) it joins that trace. No-op
        # singletons while tracing is off.
        root = tracing.open_span("serve.request", parent=parent_span,
                                 lane=f"req {rid}", request=rid,
                                 prompt_len=int(prompt.size),
                                 max_new=max_new)
        self.trace_id = root.trace_id
        self._spans = {"request": root,
                       "queue": tracing.open_span("serve.queue",
                                                  parent=root)}
        # bounded by max_new tokens + one sentinel
        self._stream = _queue.Queue()
        self._done = threading.Event()

    # -- handle surface ----------------------------------------------------

    @property
    def done(self):
        return self._done.is_set()

    @property
    def ttft(self):
        """Seconds from submit to the first token (None before it)."""
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    def wait(self, timeout=None):
        return self._done.wait(timeout)

    def result(self):
        """Generated tokens (list of ints). Raises the failure if the
        request did not complete."""
        if not self._done.is_set():
            raise RuntimeError(
                f"request {self.id} not finished (state={self.state}); "
                "wait() on it or drive the engine")
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    # -- scheduler side ----------------------------------------------------

    def _emit(self, tok, now):
        if self.first_token_t is None:
            self.first_token_t = now
            TTFT.observe(now - self.submit_t)
        self.tokens.append(tok)
        self._stream.put(tok)
        TOKENS.inc()

    def _trace_close(self, error=None):
        """Close the lifecycle spans still open, queue, prefill, decode,
        then the root (idempotent; no-ops while tracing is off)."""
        spans = self._spans
        spans.pop("queue", _NULL).close(error=error)
        spans.pop("prefill", _NULL).annotate(
            chunks=self.chunks_done).close(error=error)
        spans.pop("decode", _NULL).annotate(
            tokens=len(self.tokens)).close(error=error)
        spans.pop("request", _NULL).annotate(
            tokens=len(self.tokens), state=self.state).close(error=error)

    def _finish(self, now):
        self.state = "done"
        self.finish_t = now
        if self.anatomy is not None and self.anatomy.owner == "engine":
            anatomy.complete(self.anatomy, now, "ok",
                             tokens=len(self.tokens))
        self._trace_close()
        self._stream.put(_DONE)
        self._done.set()

    def _fail(self, exc, now):
        from ..fault.retry import classify_exception

        self.state = "failed"
        self.error = exc
        self.error_class = classify_exception(exc)
        self.finish_t = now
        if self.anatomy is not None and self.anatomy.owner == "engine":
            anatomy.complete(
                self.anatomy, now,
                "expired" if isinstance(exc, DeadlineExceeded)
                else "failed", tokens=len(self.tokens))
        self._trace_close(error=exc)
        self._stream.put(_DONE)
        self._done.set()


class Scheduler:
    """Single-threaded scheduling core (the thread-safe wrapper is
    `api.ServeEngine`; everything here assumes the caller holds its
    lock)."""

    def __init__(self, slots: SlotDecoder, max_queue=128, policy="fifo",
                 default_deadline=None, eos_id=None, seed=0):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r} (valid: {', '.join(POLICIES)})")
        self.slots = slots
        self.max_queue = int(max_queue)
        self.policy = policy
        self.default_deadline = default_deadline
        self.eos_id = eos_id
        self._seed_key = (seed & _MASK32, (seed >> 32) & _MASK32)
        self._key_ctr = 0
        S = slots.max_slots
        # bounded by the max_queue check in submit (QueueFull is the loud
        # contract; deque(maxlen=) would drop silently)
        self._queue = collections.deque()
        self._in_slot = [None] * S          # Request or None
        self._pos = onp.zeros(S, onp.int32)
        self._last = onp.zeros(S, onp.int32)
        self._active = onp.zeros(S, bool)   # decode-active (prefilled)
        self._temps = onp.ones(S, onp.float32)
        self._n_active = 0                  # occupied (prefilling+decoding)
        self._n_decoding = 0
        self._prefilled = []                # disaggregation: to migrate
        self._next_id = 0
        self.closed = False
        # cost-ledger identity (the gateway stamps the model's name) and
        # the previous step's clock for the KV page-second accrual
        self.capacity_model = "serve"
        self._cap_last_t = None
        # speculative decoding: k drafted tokens verified a round (0 =
        # one-token decode steps; a stub engine may have no spec_k)
        self._spec_k = int(getattr(slots, "spec_k", 0) or 0)

    # -- keys ---------------------------------------------------------------

    def _next_key(self):
        """The next step key: Philox4x32-10 under the seed's key at
        counter (n mod 2^32, n >> 32, 0, 1), the first two words
        (`ops._philox.fold` on host ints)."""
        self._key_ctr += 1
        n = self._key_ctr
        words = _philox.philox4x32_10((n & _MASK32, n >> 32, 0, 1),
                                      self._seed_key)
        return int(words[0]), int(words[1])

    # -- admission ----------------------------------------------------------

    def _pages_needed(self, req):
        """Pool pages for the whole request: the prompt plus every
        generated token that gets a KV write (the last sampled token is
        returned but never attended, so it needs no page). A
        ``prefill_only`` segment needs only the prompt's pages: its first
        token is sampled without a KV write, and every decode write
        happens on the replica that adopts it."""
        pt = self.slots.page_tokens
        if req.prefill_only:
            return -(-req.prompt.size // pt)
        return -(-(req.prompt.size + req.max_new - 1) // pt)

    def _pages_initial(self, req):
        """Pages allocated at admission: the whole worst case without
        speculation (decode never runs out mid-flight); with it, only the
        prompt and the first decode write position. The rest of the worst
        case stays a reservation (``spec_reserved``) that rounds draw on
        page by page and rejected suffixes give back, so unaccepted
        lookahead never holds pages while admission pressure is the
        non-speculative engine's."""
        if req.prefill_only or not self._spec_k:
            return self._pages_needed(req)
        return -(-(req.prompt.size + 1) // self.slots.page_tokens)

    def _spec_reserved_total(self):
        """Pages budgeted to live requests but not held. ``free_pages >=
        reserved_total`` is an invariant of admission, so drawing on a
        reservation never needs eviction and never deadlocks."""
        return sum(r.spec_reserved for r in self._in_slot if r is not None)

    def submit(self, prompt_ids, max_new_tokens, temperature=1.0,
               eos_id=None, deadline_s=None, parent_span=None,
               tenant=None, prefill_only=False):
        if self.closed:
            raise EngineClosed("serve engine is shut down; new work is "
                               "rejected")
        prompt = onp.asarray(prompt_ids, onp.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        total = prompt.size + max_new
        if total > self.slots.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds the engine's max_len ({self.slots.max_len})")
        if len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue} waiting, "
                f"{self._n_active}/{self.slots.max_slots} slots busy) — "
                "shed load, raise max_queue, or retry with backoff")
        if deadline_s is None:
            deadline_s = self.default_deadline
        now = time.monotonic()
        req = Request(self._next_id, prompt, max_new, float(temperature),
                      self.eos_id if eos_id is None else eos_id,
                      None if deadline_s is None else now + float(deadline_s),
                      parent_span=parent_span, tenant=tenant)
        req.prefill_only = bool(prefill_only)
        if self._pages_needed(req) > self.slots.allocator.usable_pages:
            req._trace_close()
            raise PagePoolExhausted(
                f"request needs {self._pages_needed(req)} KV pages but the "
                f"pool only has {self.slots.allocator.usable_pages} — "
                "raise n_pages or shrink prompt/max_new_tokens")
        self._next_id += 1
        req.submit_t = now
        self._queue.append(req)
        QUEUE_DEPTH.set(len(self._queue))
        return req

    def _sjf_key(self, req):
        """SJF under chunked prefill: fewest remaining prefill chunks
        first, prompt length as the cold-cache tie-break, id last."""
        shared = self.slots.prefix_cache.shared_tokens(req.prompt)
        remaining = max(1, int(req.prompt.size) - shared)
        chunks = -(-remaining // self.slots.prefill_chunk)
        return (chunks, int(req.prompt.size), req.id)

    def _next_index(self):
        if self.policy == "sjf":
            return min(range(len(self._queue)),
                       key=lambda j: self._sjf_key(self._queue[j]))
        return 0

    def _remove_at(self, i):
        self._queue.rotate(-i)
        req = self._queue.popleft()
        self._queue.rotate(i)
        return req

    # -- the step loop ------------------------------------------------------

    def step(self):
        """One scheduling iteration (expire, admit, prefill chunks,
        decode, retire). Returns True if any progress was made."""
        from ..fault.injection import inject_at

        # a host-side span: nothing a graph captures opens one
        with tracing.span("serve.step", queued=len(self._queue),
                          active=self._n_active):
            inject_at("serve_step")
            now = time.monotonic()
            self._accrue_page_seconds()
            self._expire(now)
            admitted = self._admit(now)
            chunks = self._prefill_step()
            decoded = self._decode_once()
            self._refresh_gauges()
        return bool(admitted or chunks or decoded)

    def _accrue_page_seconds(self):
        """Cost-ledger seam: resident KV pages x seconds since the last
        step, for each occupied slot (one flag check while the ledger is
        disarmed)."""
        if not capacity._ENABLED:
            self._cap_last_t = None
            return
        t = time.perf_counter()
        last, self._cap_last_t = self._cap_last_t, t
        if last is None:
            return
        dt = t - last
        if dt <= 0:
            return
        for req in self._in_slot:
            if req is not None and req.pages:
                capacity.charge_kv_page_seconds(
                    req.tenant, self.capacity_model, len(req.pages) * dt)

    def _expire(self, now):
        for req in [r for r in self._queue
                    if r.deadline is not None and now > r.deadline]:
            self._queue.remove(req)
            req._fail(DeadlineExceeded(
                f"request {req.id} expired after "
                f"{now - req.submit_t:.3f}s in queue"), now)
        for s, req in enumerate(self._in_slot):
            if req is not None and req.deadline is not None \
                    and now > req.deadline:
                self._retire(s, "deadline", now)

    def _admit(self, now):
        """Map queued requests onto free slots and their pages. The full
        page budget is taken up front (allocated, or under speculation
        partly reserved) so decode never runs out mid-flight; when even
        the unused prefix-cache entries cannot cover it, the request stays
        queued until running slots retire."""
        admitted = 0
        alloc = self.slots.allocator
        cache = self.slots.prefix_cache
        while self._queue and self._n_active < self.slots.max_slots:
            i = self._next_index()
            req = self._queue[i]
            shared_tokens, shared_pages = cache.lookup(req.prompt)
            # the budget is always the worst case: reserved pages count
            # against later admissions as allocated ones do
            need = self._pages_needed(req) - len(shared_pages)
            reserved = self._spec_reserved_total()
            if need > alloc.free_pages - reserved:
                cache.evict_unused(need + reserved)
            if need > alloc.free_pages - reserved:
                break                      # pages pinned by live requests
            self._remove_at(i)
            slot = self._in_slot.index(None)
            alloc.incref(shared_pages)
            grab = self._pages_initial(req) - len(shared_pages)
            req.pages = shared_pages + alloc.alloc(grab)
            req.spec_reserved = need - grab
            req.shared_tokens = shared_tokens
            req.prefill_pos = shared_tokens
            self.slots.set_slot_pages(slot, req.pages)
            req.state = "running"
            req.slot = slot
            self._in_slot[slot] = req
            self._n_active += 1
            admitted += 1
            if req.anatomy is not None and req.anatomy.owner == "engine":
                # a standalone engine: admission is dispatch (the gateway
                # stamps its own records at its dispatch)
                req.anatomy.dispatched(now, anatomy._sched_replica(self)[0])
            if shared_tokens:
                PREFIX_HITS.inc()
                PREFIX_TOKENS.inc(shared_tokens)
            root = req._spans.get("request", _NULL)
            req._spans.pop("queue", _NULL).close()   # admission ends the wait
            req._spans["prefill"] = tracing.open_span(
                "serve.prefill", parent=root, slot=slot,
                prompt_len=int(req.prompt.size),
                shared_tokens=shared_tokens)
        if admitted:
            QUEUE_DEPTH.set(len(self._queue))
        return admitted

    def _prefill_step(self):
        """One chunk for every slot still prefilling: chunks of different
        requests and decode steps interleave, so a long prompt cannot
        stall the engine for its whole prefill. The final chunk emits the
        request's first token and flips the slot to decoding."""
        ran = 0
        for slot, req in enumerate(self._in_slot):
            if req is None or req.prefill_pos >= req.prompt.size:
                continue
            t0 = req.prefill_pos
            n = min(self.slots.prefill_chunk, req.prompt.size - t0)
            cap_t0 = time.perf_counter() \
                if (capacity._ENABLED or anatomy._ENABLED) else None
            # the chunk returns its sampled token on the host: the window
            # closes after the chunk ran, not after its launch
            first, bucket, pad = self.slots.prefill_chunk_step(
                slot, req.prompt[t0:t0 + n], t0, self._next_key(),
                req.temperature)
            if cap_t0 is not None:
                # one window a chunk: exact per-slot prefill attribution,
                # shared by the capacity and anatomy ledgers
                if capacity._ENABLED:
                    capacity.split_device_seconds(
                        (req.tenant,), self.capacity_model, "prefill",
                        time.perf_counter() - cap_t0)
                anatomy.on_prefill_chunk(self, req, cap_t0,
                                         time.perf_counter())
            req.prefill_pos = t0 + n
            req.chunks_done += 1
            PREFILL_CHUNKS.inc()
            ran += 1
            req._spans.get("prefill", _NULL).annotate(bucket=bucket,
                                                      pad_tokens=pad)
            if req.prefill_pos < req.prompt.size:
                continue
            # the whole prompt is resident: its full pages become shareable
            self.slots.prefix_cache.register(req.prompt, req.pages)
            req._spans.pop("prefill", _NULL).annotate(
                chunks=req.chunks_done).close()
            t = time.monotonic()
            if req.anatomy is not None:
                req.anatomy.prefill_done(t, handoff=req.prefill_only)
            req._emit(first, t)
            if self._is_complete(req, first):
                # a one-token request (or instant EOS) retires without
                # joining a decode step
                req._spans.get("request", _NULL).annotate(
                    reason=self._complete_reason(req, first))
                self._retire(slot, self._complete_reason(req, first), t)
                continue
            if req.prefill_only:
                # disaggregation: the slot frees now, the page references
                # ride with the request to the migration plane
                # (`serve.disagg`, through `take_prefilled`)
                req.first_token = int(first)
                self._handoff(slot, req)
                continue
            self._pos[slot] = req.prompt.size
            self._last[slot] = first
            self._temps[slot] = max(req.temperature, 1e-6)
            self._active[slot] = True
            self._n_decoding += 1
            # the slot's decode segment of the trace, closed at retirement
            req._spans["decode"] = tracing.open_span(
                "serve.decode", parent=req._spans.get("request", _NULL),
                slot=slot)
        return ran

    def _is_complete(self, req, tok):
        return (len(req.tokens) >= req.max_new
                or (req.eos_id is not None and tok == req.eos_id))

    def _complete_reason(self, req, tok):
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        return "length"

    def _decode_once(self):
        if self._n_decoding == 0:
            return False
        if self._spec_k:
            return self._spec_decode_once()
        cap_t0 = time.perf_counter() \
            if (capacity._ENABLED or anatomy._ENABLED) else None
        # the step returns its tokens on the host: the window below closes
        # after the replay ran, not after its launch
        with tracing.span("serve.decode_step", slots=self._n_decoding):
            nxt = self.slots.decode_step(self._last, self._pos,
                                         self._active, self._next_key(),
                                         self._temps)
        if cap_t0 is not None:
            # one batched step: its wall split evenly across the slots
            # that decoded in it
            if capacity._ENABLED:
                capacity.split_device_seconds(
                    [r.tenant for s, r in enumerate(self._in_slot)
                     if r is not None and self._active[s]],
                    self.capacity_model, "decode",
                    time.perf_counter() - cap_t0)
            anatomy.on_decode_step(self, cap_t0, time.perf_counter())
        now = time.monotonic()
        for s, req in enumerate(self._in_slot):
            if req is None or not self._active[s]:
                continue                   # free or still prefilling
            tok = int(nxt[s])
            req._emit(tok, now)
            self._pos[s] += 1
            self._last[s] = tok
            if self._is_complete(req, tok):
                self._retire(s, self._complete_reason(req, tok), now)
        return True

    def _extend_spec_pages(self, slot, req, k):
        """Draw on ``req``'s reservation so that every position the verify
        step may write this round (up to ``pos + k``, capped at the last
        position the request can ever write) is page-mapped. ``len(pages)
        + spec_reserved`` stays the admission-time worst case, so the
        allocation never exceeds the reservation and cannot fail. Returns
        the last page-mapped position (the verify step's ``limit``)."""
        pt = self.slots.page_tokens
        pos = int(self._pos[slot])
        # the last written position: the final token's K/V is never stored
        res_end = req.prompt.size + req.max_new - 2
        want = min(pos + k, res_end) // pt + 1
        grab = min(want - len(req.pages), req.spec_reserved)
        if grab > 0:
            req.pages = list(req.pages) + self.slots.allocator.alloc(grab)
            req.spec_reserved -= grab
            self.slots.set_slot_pages(slot, req.pages)
        return len(req.pages) * pt - 1

    def _trim_spec_pages(self, slot, req):
        """Roll back after acceptance: pages mapped past the committed
        position go back to the free list and to the request's
        reservation. They are always this round's extension (the kept
        pages cover the prompt and an emitted token), never shared-prefix
        pages, so their refcount is 1 and the decref frees them."""
        keep = int(self._pos[slot]) // self.slots.page_tokens + 1
        if len(req.pages) > keep:
            extra = req.pages[keep:]
            req.pages = list(req.pages[:keep])
            self.slots.allocator.decref(extra)
            req.spec_reserved += len(extra)
            self.slots.set_slot_pages(slot, req.pages)

    def _spec_decode_once(self):
        """One speculative round: map the verify window's pages, draft
        ``k`` tokens (host n-gram, or the draft step), verify all ``k + 1``
        rows in one target pass, and accept on the host the longest
        drafted prefix that matches the target's tokens. Every emitted
        token is the target's own greedy choice, so the output is the
        non-speculative greedy decode's, token for token."""
        k = self._spec_k
        slots = self.slots
        cap_t0 = time.perf_counter() \
            if (capacity._ENABLED or anatomy._ENABLED) else None
        limit = onp.zeros(slots.max_slots, onp.int64)
        for s, req in enumerate(self._in_slot):
            if req is not None and self._active[s]:
                limit[s] = self._extend_spec_pages(s, req, k)
        with tracing.span("serve.spec_draft", slots=self._n_decoding, k=k):
            if slots.draft_kind == "model":
                drafts = slots.spec_draft_step(self._last, self._pos,
                                               self._active, limit)
            else:
                seqs = [None] * slots.max_slots
                for s, req in enumerate(self._in_slot):
                    if req is not None and self._active[s]:
                        seqs[s] = onp.concatenate(
                            [req.prompt, onp.asarray(req.tokens, onp.int32)])
                drafts = slots.spec_propose(seqs)
        with tracing.span("serve.spec_verify", slots=self._n_decoding,
                          k=k):
            targets = slots.spec_verify_step(self._last, drafts, self._pos,
                                             self._active, limit)
        spec_dt = 0.0
        if cap_t0 is not None:
            # draft and verify are the round's decode work, split across
            # the slots in the round (the targets are on the host here)
            if capacity._ENABLED:
                capacity.split_device_seconds(
                    [r.tenant for s, r in enumerate(self._in_slot)
                     if r is not None and self._active[s]],
                    self.capacity_model, "decode",
                    time.perf_counter() - cap_t0)
            spec_dt = anatomy.on_decode_step(self, cap_t0,
                                             time.perf_counter())
        n_round = max(self._n_decoding, 1)
        now = time.monotonic()
        for s, req in enumerate(self._in_slot):
            if req is None or not self._active[s]:
                continue
            pos = int(self._pos[s])
            # rows past the page-mapped window wrote to the trash page:
            # their targets are no continuation
            room = int(limit[s]) - pos
            m = 0
            while (m < k and m < room
                   and int(drafts[s, m]) == int(targets[s, m])):
                m += 1
            # a full accept with a model draft takes no bonus token: the
            # draft step wrote no K/V for its own last draft (positions
            # pos..pos+k-1), and moving past it would leave a hole in the
            # draft pool. The verify step wrote row k's target K/V anyway.
            bonus = 0 if m == k and slots.draft_kind == "model" else 1
            emitted, done_reason = 0, None
            for i in range(min(m + bonus, req.max_new - len(req.tokens))):
                tok = int(targets[s, i])
                req._emit(tok, now)
                emitted += 1
                if self._is_complete(req, tok):
                    done_reason = self._complete_reason(req, tok)
                    break
            accepted = min(m, emitted)
            if spec_dt and req.anatomy is not None:
                # the rejected share of this slot's part of the round is
                # speculation waste; the rest stays decode_compute
                req.anatomy.carve(
                    "spec_overhead",
                    spec_dt * (k - accepted) / max(k, 1) / n_round)
            SPEC_DRAFTED.inc(k)
            SPEC_ACCEPTED.inc(accepted)
            slots.spec_count(k, accepted)
            self._pos[s] = pos + emitted
            self._last[s] = req.tokens[-1]
            if done_reason is not None:
                self._retire(s, done_reason, now)
            else:
                self._trim_spec_pages(s, req)
        return True

    def _free_slot(self, slot):
        """Clear ``slot``'s state and drop its request's page references
        (shared pages survive through the cache's); returns the
        request."""
        req = self._in_slot[slot]
        self._in_slot[slot] = None
        if self._active[slot]:
            self._n_decoding -= 1
        self._active[slot] = False
        self._pos[slot] = 0
        self._last[slot] = 0
        self._temps[slot] = 1.0
        self._n_active -= 1
        if req.pages:
            self.slots.allocator.decref(req.pages)
        req.pages = None
        req.spec_reserved = 0
        self.slots.clear_slot(slot)
        req.slot = None
        return req

    def _retire(self, slot, reason, now):
        """Free ``slot`` and dereference its pages (shared pages survive
        through their cache references). EOS and length complete the
        request; deadline and shutdown fail it."""
        req = self._in_slot[slot]
        req._spans.get("request", _NULL).annotate(reason=reason)
        self._free_slot(slot)
        EVICTIONS.inc()
        registry.counter(
            "mx_serve_evictions_total",
            "slots freed (EOS / length / deadline / shutdown)",
            labels={"reason": reason}).inc()
        if reason == "deadline":
            req._fail(DeadlineExceeded(
                f"request {req.id} expired mid-flight after "
                f"{len(req.tokens)}/{req.max_new} tokens"), now)
        elif reason == "shutdown":
            req._fail(EngineClosed(
                f"engine shut down with request {req.id} mid-flight "
                f"({len(req.tokens)}/{req.max_new} tokens)"), now)
        else:
            req._finish(now)

    def preempt(self, slot, now=None):
        """Evict the request in ``slot`` without finishing or failing it
        (the seam of a gateway's priority preemption).

        The page-aligned part of its resident work (prefilled prompt
        pages and decoded-token pages) is registered in the prefix cache
        before the slot's references drop, so a resubmission of ``prompt
        + tokens so far`` re-attaches those pages as a shared prefix and
        prefills only the unaligned tail. Under page pressure the cached
        pages are reclaimed through `PrefixCache.evict_unused` as any
        other entry's: preempted work pins no pages. Returns the `Request`
        with ``state="preempted"`` and its trace closed; re-queueing what
        is left is the caller's. ``now`` is the caller's clock (the
        gateway's step), taken here when absent."""
        if now is None:
            now = time.monotonic()
        req = self._in_slot[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty: nothing to preempt")
        pt = self.slots.page_tokens
        # tokens whose K/V is in the pool: the prefilled range of a
        # prefilling slot, pos (prompt and all but the newest token) of a
        # decoding one
        resident = int(self._pos[slot]) if self._active[slot] \
            else int(req.prefill_pos)
        aligned = resident // pt * pt
        if aligned and req.pages:
            gen = req.tokens[:max(0, resident - req.prompt.size)]
            seq = onp.concatenate(
                [req.prompt, onp.asarray(gen, onp.int32)])[:aligned]
            self.slots.prefix_cache.register(seq, req.pages[:aligned // pt])
        self._free_slot(slot)
        req.state = "preempted"
        EVICTIONS.inc()
        registry.counter(
            "mx_serve_evictions_total",
            "slots freed (EOS / length / deadline / shutdown)",
            labels={"reason": "preempted"}).inc()
        req._spans.get("request", _NULL).annotate(
            reason="preempted", resident_tokens=resident,
            kept_pages=aligned // pt)
        req._trace_close()
        return req

    # -- disaggregation: the prefill/decode hand-off (`serve.disagg`) -------

    def _handoff(self, slot, req):
        """Free ``slot`` without dropping the request's page references:
        the prompt's K/V stays resident (the prefix cache's references and
        the request's own) while the request moves to the migration
        plane. The slot is free for the next prompt at once: a prefill
        replica's slots turn over a prompt at a time."""
        self._in_slot[slot] = None
        self._n_active -= 1
        self.slots.clear_slot(slot)
        req.slot = None
        req.state = "prefilled"
        self._prefilled.append(req)

    def take_prefilled(self):
        """Claim the requests whose prefill-only segment completed since
        the last call. The caller (the migration plane) inherits their
        page references and must migrate, adopt or release each one."""
        out, self._prefilled = self._prefilled, []
        return out

    @property
    def prefill_backlog(self):
        """Prefill chunks still owed: the queued prompts' and the unrun
        rest of every prefilling slot's (the router's placement key for
        prefill replicas)."""
        pc = self.slots.prefill_chunk
        n = 0
        for r in self._queue:
            n += -(-max(1, int(r.prompt.size)) // pc)
        for r in self._in_slot:
            if r is not None and r.prefill_pos < r.prompt.size:
                n += -(-(int(r.prompt.size) - r.prefill_pos) // pc)
        return n

    def adopt_page_plan(self, prompt_len, max_new):
        """The page budget of adopting a prefilled request: ``(content,
        physical, reserved)``. ``content`` pages carry the migrated
        prompt's K/V, ``physical`` pages are what the caller hands to
        `adopt` (under speculation the tail stays a reservation, as in
        `_pages_initial`), and ``reserved`` seeds ``spec_reserved``."""
        pt = self.slots.page_tokens
        content = -(-prompt_len // pt)
        total = -(-(prompt_len + max_new - 1) // pt)
        if self._spec_k:
            physical = max(content, -(-(prompt_len + 1) // pt))
        else:
            physical = total
        return content, physical, total - physical

    def adopt(self, prompt_ids, first_token, max_new_tokens, pages,
              spec_reserved=0, temperature=1.0, eos_id=None,
              deadline_s=None, parent_span=None, tenant=None):
        """Admit a request whose prefill ran elsewhere: the decode half of
        the hand-off. ``pages`` (owned from now on, no incref) already
        hold the prompt's K/V in this engine's pool, as `adopt_page_plan`
        sizes them; ``first_token`` is the token the prefill side
        sampled. The request enters decoding at once, so this replica
        never runs a prefill chunk for it.

        The adopted request is page for page and position for position
        the one that would have prefilled here (the first token seeded as
        ``tokens[0]``, ``pos`` at the prompt's end), so its greedy decode
        is bit for bit the co-located one."""
        if self.closed:
            raise EngineClosed("serve engine is shut down; new work is "
                               "rejected")
        if self._n_active >= self.slots.max_slots:
            raise QueueFull(
                f"no free slot to adopt into "
                f"({self._n_active}/{self.slots.max_slots} busy): the "
                "migration plane must pick a replica that can take it")
        prompt = onp.asarray(prompt_ids, onp.int32).reshape(-1)
        max_new = int(max_new_tokens)
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.default_deadline
        req = Request(self._next_id, prompt, max_new, float(temperature),
                      self.eos_id if eos_id is None else eos_id,
                      None if deadline_s is None else now + float(deadline_s),
                      parent_span=parent_span, tenant=tenant)
        self._next_id += 1
        req.submit_t = now
        # the first token was sampled (and its TTFT observed) on the
        # prefill side: seeded, not emitted again
        req.first_token_t = now
        req.first_token = int(first_token)
        req.tokens.append(int(first_token))
        req.prefill_pos = prompt.size
        slot = self._in_slot.index(None)
        req.pages = list(pages)
        req.spec_reserved = int(spec_reserved)
        self.slots.set_slot_pages(slot, req.pages)
        req.state = "running"
        req.slot = slot
        self._in_slot[slot] = req
        self._n_active += 1
        self._pos[slot] = prompt.size
        self._last[slot] = int(first_token)
        self._temps[slot] = max(float(temperature), 1e-6)
        self._active[slot] = True
        self._n_decoding += 1
        root = req._spans.get("request", _NULL)
        root.annotate(adopted=True)
        req._spans.pop("queue", _NULL).close()
        req._spans["decode"] = tracing.open_span(
            "serve.decode", parent=root, slot=slot)
        return req

    def finish_handoff(self, req):
        """Close a prefilled segment whose work moved on (migrated or
        re-queued); its pages were handed off or released by the caller,
        so this settles only the trace."""
        req.state = "migrated"
        req._trace_close()

    @property
    def free_slots(self):
        return self.slots.max_slots - self._n_active

    def _refresh_gauges(self):
        QUEUE_DEPTH.set(len(self._queue))
        SLOT_OCCUPANCY.set(self._n_active / self.slots.max_slots)

    # -- lifecycle ----------------------------------------------------------

    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def n_active(self):
        return self._n_active

    @property
    def idle(self):
        return self._n_active == 0 and not self._queue

    def close(self, drain):
        """Stop admission. With ``drain`` the caller keeps stepping until
        the occupied slots finish (prefilling ones complete their chunks
        first); queued, never-started requests fail either way."""
        self.closed = True
        now = time.monotonic()
        while self._queue:
            req = self._queue.popleft()
            req._fail(EngineClosed(
                f"engine shut down before request {req.id} was "
                "admitted"), now)
        # prefilled segments awaiting migration cannot finish on a closed
        # engine: their pages go back and they fail loudly
        for req in self._prefilled:
            if req.pages:
                self.slots.allocator.decref(req.pages)
            req.pages = None
            req._fail(EngineClosed(
                f"engine shut down with request {req.id} awaiting "
                "migration"), now)
        self._prefilled = []
        if not drain:
            for s, req in enumerate(self._in_slot):
                if req is not None:
                    self._retire(s, "shutdown", now)
        self._refresh_gauges()

    def abandon(self):
        """Teardown after the engine under this scheduler died, with every
        in-flight request already owned by the caller: unlike `close`,
        nothing is failed; queue and slots are dropped as they are so the
        page pool can be released."""
        self.closed = True
        self._queue.clear()
        self._in_slot = [None] * self.slots.max_slots
        self._prefilled = []
        self._n_active = 0
        self._refresh_gauges()
