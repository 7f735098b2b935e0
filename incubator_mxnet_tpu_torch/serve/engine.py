"""Paged slot-cache decoding, the device half of `serve` (port of
`incubator_mxnet_tpu/serve/engine.py`: `PagePoolExhausted` :137,
`PageAllocator` :144, `PrefixCache` :232, `SlotDecoder` :361, its page
migration :711-766) on one card:
the KV pool in the weights' dtype or in int8, and speculative decoding
with an n-gram or a draft-model draft.

- **page pool**: per layer, one K and one V tensor of shape ``(n_pages,
  H, page_tokens, d)``, allocated once and written in place. Page 0 is
  the *trash* page: unallocated page-table entries and the writes of
  inactive slots land there, and no mask ever admits it.
- **int8 pool** (``kv_dtype="int8"``): the K and V tensors hold int8
  codes and each layer adds two ``(n_pages, H)`` f32 scale planes, one
  scale per (page, head) in the symmetric +-127 convention of
  `contrib.quantization`. A prefill chunk quantizes its whole pages; a
  token write raises the page's scale only when it must (grow-only) and
  re-quantizes that one page. Reads dequantize the gathered pages.
- **page table**: a host ``(max_slots, pages_per_slot)`` array mapping
  each slot's token range to pool pages, copied into a device buffer only
  when an allocation changed it. Decode gathers each slot's view of the
  pool through its table row; prefill writes whole pages.
- **allocator and prefix cache**: `PageAllocator` (host free list and
  refcounts; the loud `PagePoolExhausted`, nothing referenced is ever
  evicted) and `PrefixCache` (digest of a page-aligned token prefix ->
  its pages), so a shared system prompt is prefilled once and its pages
  attached read-only to every later request that starts with it.

Functions that run against the pool:

- **chunked prefill** (`SlotDecoder.prefill_chunk_step`, eager): one
  page-aligned chunk of one request's prompt, padded to a chunk bucket
  (`models.decoding.chunk_buckets`). It embeds the chunk at its true
  positions, writes its K/V pages, attends its queries to the slot's
  gathered view under the causal-with-offset mask (key j is visible to
  row i iff j <= t_start + i; K1's causal mask is aligned at query 0 and
  cannot express it) and samples a first token from the chunk's last
  real row: one host sync, the token. Under int8 the chunk attends to its
  own K/V before quantization. A model draft prefills the same chunk into
  its own pools.
- **decode** (`SlotDecoder.decode_step`): one token for every slot. Each
  slot writes its new K/V at ``table[s, pos // page_tokens]``, offset
  ``pos % page_tokens`` (inactive slots write to the trash page), gathers
  its view, attends under ``key <= pos`` in f32 and samples.
- **verify** (`SlotDecoder.spec_verify_step`, ``spec_k > 0``): the
  target runs ``k + 1`` rows for every slot in one batched pass, row
  ``i`` consuming ``[last, d_1..d_k][i]`` at position ``pos + i`` and
  attending to positions ``<= pos + i``, so the pass equals ``k + 1``
  sequential decode steps; each row's K/V is written column by column
  (the int8 scales depend on the order), rows past the slot's mapped
  pages write to the trash page, and the output is each row's greedy
  token.
- **draft** (`SlotDecoder.spec_draft_step`, model drafts only): ``k``
  unrolled greedy decode steps of the draft model against its own
  per-layer pools (same page table and allocator). The ``"ngram"`` draft
  runs on the host (`models.decoding.NgramProposer`) with no device work.

On a CUDA model each of decode, verify and draft is **one CUDA graph**,
captured once over the static pools and input buffers and replayed every
call; on a CPU model the same functions run eagerly. Acceptance of drafts
is host work in the scheduler.

Every LayerNorm of all four is the LayerNorm kernel (K4), through
`models.decoding.GPTDecoder`'s layer helpers: 2 a layer and the final one
a pass, over S rows in decode, S (k + 1) in verify, S in each draft step.
The disaggregation hand-off's transfer (`SlotDecoder.copy_pages_out` and
``copy_pages_in``, reference :711-766) gathers whole pages into device
tensors and writes them into the peer's pools in place, so the captured
graphs read them at their next replay.

Observability (reference :619-659, :917-929): the first prefill registers
two device-memory census owners (`telemetry.hbm`),
``"{census_name}.kv_pool"`` (every leaf of the pools, with the prefix
cache's share as ``derived``) and ``"{census_name}.params"``; each program
the engine builds (a captured step, or on a CPU model a step's first call
under new weights, and a new prefill bucket's first eager run) is one
entry of the program ledger (`telemetry.compiles`) under
``"{census_name}.{prefill,draft_prefill,decode,verify,draft}"``, so the
ledger counts what `xla_program_count` counts. The sharding pre-flight
and `hbm_crosscheck` (shardcheck's SC006) are not ported yet
(`ROADMAP.md` §1 items 9 and 10).

Stale-row safety (the reference's argument, per page): position ``p`` of
a slot enters the mask only once the slot's ``pos`` reaches ``p``, and
the step that advances ``pos`` to ``p`` writes ``p``'s K/V first, so a
reused page's old contents, chunk padding and the generation headroom
are never read.
"""
from __future__ import annotations

import hashlib
import math
import os
import time
import weakref

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..contrib.quantization import quantize_symmetric
from ..models.decoding import (GPTDecoder, NgramProposer, bucket_chunk,
                               chunk_buckets)
from ..ops import _philox
from ..telemetry import compiles as _compiles
from ..telemetry import hbm as _hbm
from ..telemetry import registry
from ..util import env_int

__all__ = ["SlotDecoder", "PageAllocator", "PrefixCache",
           "PagePoolExhausted", "DEFAULT_PAGE_TOKENS",
           "DEFAULT_PREFILL_CHUNK"]

#: Tokens per KV page (MXNET_SERVE_PAGE_TOKENS).
DEFAULT_PAGE_TOKENS = 16
#: Prefill chunk ceiling in tokens (MXNET_SERVE_PREFILL_CHUNK); rounded
#: up to a multiple of the page size.
DEFAULT_PREFILL_CHUNK = 64
#: The steps replayed as CUDA graphs on the card.
_STEPS = ("decode", "verify", "draft")

PAD_TOKENS = registry.counter(
    "mx_decode_bucket_pad_tokens_total",
    "prompt tokens added by pad-to-bucket in the decode/serving "
    "path (padding waste)")


class PagePoolExhausted(RuntimeError):
    """The KV page pool cannot satisfy an allocation. Pages referenced by
    live requests or the prefix cache are never silently evicted to make
    room: shed load, shrink max_new_tokens, raise ``n_pages``, or let
    running requests retire."""


class PageAllocator:
    """Host-side page accounting for the paged KV pool.

    Pure bookkeeping: it never touches device memory. Page 0 is the trash
    page (never allocated, never read through a mask). Shared pages are
    reference-counted: a page returns to the free list only when its last
    reference (requests and prefix-cache entries) drops it.
    """

    def __init__(self, n_pages, page_tokens):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is reserved), "
                             f"got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        # LIFO free list: hot pages are reused first
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._ref = onp.zeros(self.n_pages, onp.int64)

    @property
    def usable_pages(self):
        """Allocatable pages (total minus the trash page)."""
        return self.n_pages - 1

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def used_pages(self):
        """Pages currently referenced, shared pages counted once."""
        return self.usable_pages - len(self._free)

    def refcount(self, page):
        return int(self._ref[page])

    def alloc(self, n):
        """Take ``n`` fresh pages (refcount 1 each). Raises the loud
        `PagePoolExhausted` when the pool cannot satisfy the request."""
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"KV page pool exhausted: need {n} pages, "
                f"{len(self._free)}/{self.usable_pages} free "
                f"({self.used_pages} referenced by live requests or the "
                "prefix cache) — shed load, raise n_pages, or wait for "
                "running requests to retire; shared pages are never "
                "silently evicted")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages):
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(
                    f"incref on free page {p} — a shared page was dropped "
                    "while still mapped (allocator bookkeeping bug)")
            self._ref[p] += 1

    def decref(self, pages):
        """Release one reference per page; pages whose count reaches zero
        return to the free list."""
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
            elif self._ref[p] < 0:
                raise RuntimeError(
                    f"double free of page {p} (refcount went negative) — "
                    "allocator bookkeeping bug")


class _PrefixEntry:
    __slots__ = ("pages", "tokens", "last_used")

    def __init__(self, pages, tokens, last_used):
        self.pages = pages
        self.tokens = tokens
        self.last_used = last_used


class PrefixCache:
    """Shared-prefix page reuse: digest of a page-aligned token prefix ->
    its pages.

    Entries hold their own page references, so a cached prefix outlives
    the request that prefilled it; `evict_unused` drops the least recently
    used entries (their references only: pages still mapped into live
    requests stay allocated). Every page boundary of a registered prompt
    gets its own entry, so a later prompt reuses its longest match. A
    lookup always leaves at least one prompt token uncovered: the final
    token must run through prefill to produce the first sampled token.
    """

    def __init__(self, allocator, enabled=True):
        self._alloc = allocator
        self._entries = {}
        self._clock = 0
        self.enabled = bool(enabled)

    def __len__(self):
        return len(self._entries)

    @property
    def cached_pages(self):
        """Pages referenced by at least one cache entry (counted once)."""
        seen = set()
        for e in self._entries.values():
            seen.update(e.pages)
        return len(seen)

    def _page_digests(self, prompt, n_pages):
        """Rolling blake2b digest at each of the first ``n_pages`` page
        boundaries of ``prompt`` (one pass over the token bytes)."""
        pt = self._alloc.page_tokens
        arr = onp.ascontiguousarray(onp.asarray(prompt, onp.int32))
        h = hashlib.blake2b(digest_size=16)
        out = []
        for jj in range(n_pages):
            h.update(arr[jj * pt:(jj + 1) * pt].tobytes())
            out.append(h.digest())
        return out

    def shared_tokens(self, prompt):
        """Length in tokens of the longest cached page-aligned proper
        prefix of ``prompt`` (0 when nothing matches). A read-only probe,
        no LRU touch, for the scheduler's remaining-chunk SJF key."""
        tokens, _ = self._match(prompt, touch=False)
        return tokens

    def lookup(self, prompt):
        """Longest cached page-aligned proper prefix -> ``(tokens,
        pages)``. Takes no page references: the caller increfs the pages
        if, and only if, it maps them into a request."""
        return self._match(prompt, touch=True)

    def _match(self, prompt, touch):
        if not self.enabled or not self._entries:
            return 0, []
        pt = self._alloc.page_tokens
        max_pages = (len(prompt) - 1) // pt
        if max_pages < 1:
            return 0, []
        digests = self._page_digests(prompt, max_pages)
        for jj in range(max_pages, 0, -1):
            e = self._entries.get(digests[jj - 1])
            if e is not None:
                if touch:
                    self._clock += 1
                    e.last_used = self._clock
                return jj * pt, list(e.pages)
        return 0, []

    def register(self, prompt, pages):
        """Make the prompt's full pages shareable. ``pages`` is the
        request's page list, its prefill complete. Returns the number of
        new entries; idempotent per prefix."""
        if not self.enabled:
            return 0
        pt = self._alloc.page_tokens
        n_full = len(prompt) // pt
        if n_full < 1:
            return 0
        digests = self._page_digests(prompt, n_full)
        added = 0
        for jj in range(1, n_full + 1):
            d = digests[jj - 1]
            if d in self._entries:
                continue
            entry_pages = tuple(int(p) for p in pages[:jj])
            self._alloc.incref(entry_pages)
            self._clock += 1
            self._entries[d] = _PrefixEntry(entry_pages, jj * pt,
                                            self._clock)
            added += 1
        return added

    def evict_unused(self, pages_needed):
        """Drop least recently used entries until at least
        ``pages_needed`` pages are free or no entries remain. Only cache
        references drop: a page still mapped into a live request keeps a
        nonzero refcount and is never reused from under it. Returns the
        entries dropped."""
        if self._alloc.free_pages >= pages_needed:
            return 0
        dropped = 0
        for d, e in sorted(self._entries.items(),
                           key=lambda kv: kv[1].last_used):
            if self._alloc.free_pages >= pages_needed:
                break
            self._alloc.decref(e.pages)
            del self._entries[d]
            dropped += 1
        if dropped:
            registry.counter(
                "mx_serve_prefix_evictions_total",
                "prefix-cache entries dropped to free pages (cache refs "
                "only — live requests keep their pages)").inc(dropped)
        return dropped

    def clear(self):
        for e in self._entries.values():
            self._alloc.decref(e.pages)
        self._entries.clear()


def _gumbel(shape, key):
    """Gumbel noise of ``shape`` (f32) from the Philox words of ``key``
    (two int64 words on the device) at the flat indices of ``shape``."""
    words = _philox.random_words(math.prod(shape), (key[0], key[1]),
                                 key.device)
    u = (words.double() + 0.5) * 2.0 ** -32      # in (0, 1)
    return (-torch.log(-torch.log(u))).float().reshape(shape)


def _as_decoder(source, what):
    """``source`` as a `GPTDecoder` (a `GPTDecoder`, or a GPT-shaped model
    it wraps)."""
    if isinstance(source, GPTDecoder):
        return source
    if hasattr(source, "blocks") and hasattr(source, "position_embed"):
        return GPTDecoder(source)
    raise TypeError(
        f"{what} needs a GPTDecoder or a GPT-shaped model (blocks + "
        f"position_embed), got {type(source).__name__}")


class SlotDecoder:
    """Paged slot-cache decoder over a `GPTDecoder`, or the `GPTModel` it
    would wrap.

    Parameters
    ----------
    source : GPTDecoder or GPTModel
        The model to serve; its weights are read from its modules.
    max_slots : int
        Static batch width of the decode step.
    max_len : int
        Per-slot sequence capacity (prompt + generated); defaults to the
        model's position-embedding length.
    page_tokens : int
        Tokens per KV page (default ``MXNET_SERVE_PAGE_TOKENS`` or 16).
    prefill_chunk : int
        Prefill chunk ceiling in tokens (default
        ``MXNET_SERVE_PREFILL_CHUNK`` or 64), rounded up to a multiple of
        ``page_tokens`` and capped at the slot view.
    n_pages : int
        Pool pages including the trash page 0. Defaults to full backing
        for every slot (``max_slots * pages_per_slot + 1``).
    kv_dtype : "fp" or "int8"
        KV storage (default ``MXNET_SERVE_KV_DTYPE`` or "fp": the weights'
        dtype). "int8" stores each layer's pool as int8 codes with one f32
        scale per (page, head).
    prefix_reuse : bool
        Arm the shared-prefix cache (default True).
    do_sample / top_k
        Sampling mode, fixed per engine; the temperature stays a per-slot
        runtime input. Sampling is Gumbel-max on the Philox words of the
        step's key.
    spec_k : int
        Speculative decoding draft length (default ``MXNET_SERVE_SPEC_K``
        or 0 = off). Needs greedy decoding.
    draft : "ngram", GPTDecoder or GPTModel
        Draft source when ``spec_k > 0`` (default
        ``MXNET_SERVE_SPEC_DRAFT`` or "ngram", the host
        `models.decoding.NgramProposer`): a model draft shares the
        target's vocabulary and device and holds at least ``max_len``
        positions.

    On a CUDA model the decode step, the verify step and the draft step
    are each captured as a CUDA graph: a weight fingerprint's first call
    of a step runs it eagerly on a side stream (kernel loads, cuBLAS
    handles), the second captures it and replays it, and every later call
    copies its inputs into the graph's static buffers and replays. The
    capture runs in whichever thread steps the engine (the driver thread
    of `ServeEngine.start`), in the ``"thread_local"`` capture mode, so
    other threads' CUDA calls do not invalidate it. A capture that fails
    raises `MXNetError`; nothing falls back to eager steps on the card.
    The graphs read the weights by address: a weight updated in place is
    seen, and one replaced by a new tensor changes the fingerprint (the
    ``data_ptr`` of every parameter of the target and the draft model),
    which drops the graphs so the next calls capture again. The prefix
    cache keeps pages prefilled under earlier weights, as the reference's
    does (its hot swap lets in-flight KV continue under new weights): a
    caller that swaps weights and wants fresh prefixes clears
    ``prefix_cache``.
    """

    def __init__(self, source, max_slots=8, max_len=None, page_tokens=None,
                 prefill_chunk=None, n_pages=None, kv_dtype=None,
                 prefix_reuse=True, do_sample=False, top_k=None,
                 spec_k=None, draft=None):
        self._dec = _as_decoder(source, "SlotDecoder")
        model_max = self._dec._max_length
        self.max_len = int(max_len) if max_len is not None else model_max
        if self.max_len > model_max:
            raise ValueError(
                f"max_len ({self.max_len}) exceeds the model's position "
                f"table ({model_max})")
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")

        pt = int(page_tokens) if page_tokens is not None else \
            env_int("MXNET_SERVE_PAGE_TOKENS", DEFAULT_PAGE_TOKENS)
        if pt < 1:
            raise ValueError(f"page_tokens must be >= 1, got {pt}")
        self.page_tokens = pt
        self.pages_per_slot = -(-self.max_len // pt)          # ceil
        self.view_tokens = self.pages_per_slot * pt
        chunk = int(prefill_chunk) if prefill_chunk is not None else \
            env_int("MXNET_SERVE_PREFILL_CHUNK", DEFAULT_PREFILL_CHUNK)
        chunk = max(pt, -(-chunk // pt) * pt)                 # page-align up
        self.prefill_chunk = min(chunk, self.view_tokens)
        self.chunk_buckets = chunk_buckets(pt, self.prefill_chunk)

        if kv_dtype is None:
            kv_dtype = os.environ.get("MXNET_SERVE_KV_DTYPE", "fp")
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(
                f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r} "
                "(MXNET_SERVE_KV_DTYPE)")
        self.kv_dtype = kv_dtype
        self._int8 = kv_dtype == "int8"

        default_pages = self.max_slots * self.pages_per_slot + 1
        self.n_pages = int(n_pages) if n_pages is not None else default_pages
        self.allocator = PageAllocator(self.n_pages, pt)
        self.prefix_cache = PrefixCache(self.allocator,
                                        enabled=bool(prefix_reuse))
        registry.register_pull_gauge(
            "mx_serve_page_occupancy",
            _occupancy_probe(self.allocator),
            "fraction of usable KV pool pages referenced (shared pages "
            "counted once) [0, 1]")

        self._do_sample = bool(do_sample)
        self._top_k = None if top_k is None else int(top_k)

        # -- speculative decoding ------------------------------------------
        self.spec_k = int(spec_k) if spec_k is not None else \
            env_int("MXNET_SERVE_SPEC_K", 0)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if draft is None:
            draft = os.environ.get("MXNET_SERVE_SPEC_DRAFT", "ngram")
        self.draft_kind = "off"
        self._draft_dec = None
        self._ngram = None
        if self.spec_k:
            if self._do_sample:
                raise ValueError(
                    "speculative decoding (spec_k > 0) requires greedy "
                    "decoding (do_sample=False): greedy verification is "
                    "what makes spec output token-for-token identical")
            if isinstance(draft, str):
                if draft != "ngram":
                    raise ValueError(
                        f"unknown draft source {draft!r} "
                        "(MXNET_SERVE_SPEC_DRAFT): expected 'ngram', a "
                        "GPTDecoder, or a GPT-shaped model")
                self.draft_kind = "ngram"
                self._ngram = NgramProposer(self.spec_k)
            else:
                dd = _as_decoder(draft, "the draft")
                if dd._max_length < self.max_len:
                    raise ValueError(
                        f"draft model position table ({dd._max_length}) "
                        f"is shorter than max_len ({self.max_len})")
                dv = dd._model.word_embed.weight.shape[0]
                tv = self._dec._model.word_embed.weight.shape[0]
                if dv != tv:
                    raise ValueError(
                        f"draft vocab ({dv}) != target vocab ({tv}): "
                        "drafted token ids index the target embedding")
                if dd._model.device != self._device:
                    raise ValueError(
                        f"draft model on {dd._model.device}, target on "
                        f"{self._device}")
                self.draft_kind = "model"
                self._draft_dec = dd
        self._spec_drafted = 0              # lifetime drafted tokens
        self._spec_accepted = 0             # lifetime accepted drafts
        self._spec_gauge = False
        # registry label of this engine's series (the reference's
        # compile-ledger and HBM-census attribution name)
        self.census_name = "serve"

        # host page table; its device copy is refreshed only when an
        # allocation changed it
        self._table = onp.zeros((self.max_slots, self.pages_per_slot),
                                onp.int32)
        self._table_dirty = True
        # the decode step's host inputs, uploaded with one copy: last_tok,
        # pos, active (0/1) and the step key's two words
        self._step_host = onp.zeros(3 * self.max_slots + 2, onp.int64)
        self._temp_host = None
        # the verify and draft steps' host inputs: the (S, k + 1) tokens
        # [last, drafts], pos, active and limit
        self._spec_host = onp.zeros(self.max_slots * (self.spec_k + 4),
                                    onp.int64)
        # per-layer pools (target and draft; int8 adds the scale planes)
        # and the device buffers the graphs read, allocated together
        # (`_ensure_pool`) and dropped together
        self._pk = self._pv = self._sk = self._sv = None
        self._dpk = self._dpv = self._dsk = self._dsv = None
        self._table_dev = self._step_dev = self._temp_dev = None
        self._spec_dev = None
        self._buckets_seen = set()
        self._builds = 0            # programs built: graphs, or CPU fps
        self._program_fp = {}       # step name -> weight fingerprint
        self._graphs = {}           # step name -> (CUDAGraph, its output)
        self.captures = 0           # graphs captured (card only)
        self.captures_by_step = dict.fromkeys(_STEPS, 0)

    @property
    def _device(self):
        return self._dec._model.device

    # -- page table ---------------------------------------------------------

    def set_slot_pages(self, slot, pages):
        """Bind ``pages`` (host ints) as ``slot``'s logical token range;
        entries past the list point at the trash page."""
        if len(pages) > self.pages_per_slot:
            raise ValueError(
                f"{len(pages)} pages exceed the slot view "
                f"({self.pages_per_slot})")
        self._table[slot, :] = 0
        self._table[slot, :len(pages)] = pages
        self._table_dirty = True

    def clear_slot(self, slot):
        self._table[slot, :] = 0
        self._table_dirty = True

    def _table_device(self):
        if self._table_dirty:
            self._table_dev.copy_(
                torch.from_numpy(self._table.astype(onp.int64)))
            self._table_dirty = False
        return self._table_dev

    # -- pool ---------------------------------------------------------------

    def _make_pools(self, dec):
        """Per-layer page pools of ``dec``: tuples of L tensors ``(n_pages,
        H, page_tokens, d)`` in the weights' dtype on the model's device,
        or int8 with per-layer ``(n_pages, H)`` f32 scale planes."""
        blocks = dec._model.blocks
        H = dec._n_heads
        shape = (self.n_pages, H, self.page_tokens, dec._units // H)
        dev = self._device

        def planes(shape, dtype):
            return tuple(torch.zeros(shape, dtype=dtype, device=dev)
                         for _ in blocks)

        if self._int8:
            return (planes(shape, torch.int8), planes(shape, torch.int8),
                    planes(shape[:2], torch.float32),
                    planes(shape[:2], torch.float32))
        dtype = blocks[0].attn.qkv.weight.dtype
        return planes(shape, dtype), planes(shape, dtype), None, None

    def _layer_pools(self, draft=False):
        """Per layer ``(pk, pv, sk, sv)`` of the target's (or the draft's)
        pools; the scales are None in an fp pool."""
        pools = ((self._dpk, self._dpv, self._dsk, self._dsv) if draft
                 else (self._pk, self._pv, self._sk, self._sv))
        L = len(pools[0])
        return zip(*(p if p is not None else (None,) * L for p in pools))

    def _ensure_pool(self):
        if self._pk is not None:
            return
        self._pk, self._pv, self._sk, self._sv = self._make_pools(self._dec)
        if self._draft_dec is not None:
            (self._dpk, self._dpv,
             self._dsk, self._dsv) = self._make_pools(self._draft_dec)
        dev, S = self._device, self.max_slots
        self._table_dev = torch.zeros((S, self.pages_per_slot),
                                      dtype=torch.int64, device=dev)
        self._step_dev = torch.zeros(3 * S + 2, dtype=torch.int64,
                                     device=dev)
        self._temp_dev = torch.ones(S, dtype=torch.float32, device=dev)
        self._spec_dev = torch.zeros(self._spec_host.size,
                                     dtype=torch.int64, device=dev)
        self._temp_host = None
        self._table_dirty = True
        self._register_hbm_owners()

    def _register_hbm_owners(self):
        """Attribute this engine's device memory to named census owners
        (`telemetry.hbm`): the KV pool (every pool leaf, with the prefix
        cache's share as derived page math — cached pages live inside the
        pool tensors) and the decoder params. The probes hold a weakref
        and read host state only, so a released engine drops out of the
        census and a sampler thread never syncs the card."""
        ref = weakref.ref(self)

        def _pool_probe():
            eng = ref()
            if eng is None or eng._pk is None:
                return None
            page_bytes = eng.cache_bytes / eng.n_pages if eng.n_pages else 0
            cached = eng.prefix_cache.cached_pages
            return {
                "arrays": eng._pool_leaves(),
                "detail": {"kv_dtype": eng.kv_dtype,
                           "n_pages": eng.n_pages,
                           "pages_used": eng.allocator.used_pages,
                           "prefix_cached_pages": cached},
                "derived": {"prefix_cache": int(cached * page_bytes)},
            }

        def _params_probe():
            eng = ref()
            if eng is None:
                return None
            models = [eng._dec._model]
            if eng._draft_dec is not None:
                models.append(eng._draft_dec._model)
            return {"arrays": [p for m in models for p in m.parameters()]}

        _hbm.register_owner(f"{self.census_name}.kv_pool", _pool_probe)
        _hbm.register_owner(f"{self.census_name}.params", _params_probe)

    def _pool_leaves(self):
        return [t for leaves in (self._pk, self._pv, self._sk, self._sv,
                                 self._dpk, self._dpv, self._dsk, self._dsv)
                if leaves is not None for t in leaves]

    def release(self):
        """Drop the device pools and the graphs with them (shutdown); the
        next prefill reallocates and the steps capture again."""
        self._pk = self._pv = self._sk = self._sv = None
        self._dpk = self._dpv = self._dsk = self._dsv = None
        self._table_dev = self._step_dev = self._temp_dev = None
        self._spec_dev = None
        self._graphs.clear()
        self._program_fp.clear()
        self._table_dirty = True

    @property
    def cache_bytes(self):
        """Device bytes held by the KV pools, target and (with a model
        draft) draft, scale planes included; 0 if released."""
        return sum(t.numel() * t.element_size() for t in self._pool_leaves())

    @property
    def kv_bytes_per_slot(self):
        """Resident pool bytes per decode slot (int8 about a quarter of
        f32's)."""
        if self._pk is None:
            return 0
        return self.cache_bytes / self.max_slots

    @property
    def page_bytes(self):
        """Bytes one pool page holds across all layers (K + V, plus the
        int8 scale planes), from the shapes, so it needs no allocated
        pool: the migration plane's unit (its bytes counter is pages moved
        times this)."""
        dec = self._dec
        blocks = dec._model.blocks
        H = dec._n_heads
        d = dec._units // H
        if self._int8:
            # int8 K and V slabs plus two f32 per-(page, head) scales
            per_layer = 2 * H * self.page_tokens * d + 2 * H * 4
        else:
            itemsize = blocks[0].attn.qkv.weight.element_size()
            per_layer = 2 * H * self.page_tokens * d * itemsize
        return len(blocks) * per_layer

    # -- page migration (the disaggregation hand-off's transfer seam) -------

    @torch.no_grad()
    def copy_pages_out(self, pages):
        """Gather pool pages ``pages`` (whole pages) of every layer's K and
        V planes, and int8's scale planes, into new device tensors: the
        export half of the hand-off (`serve.disagg` is its caller).
        Returns an opaque payload for the ``copy_pages_in`` of an engine
        of the same shapes. The replicas share the card, so the payload
        stays on it."""
        self._ensure_pool()
        return self._gather_pages(self._page_index(pages))

    @torch.no_grad()
    def copy_pages_in(self, pages, payload):
        """Write a peer engine's `copy_pages_out` payload into this pool at
        ``pages``, whole pages, so the bytes land bit for bit. The write
        is in place (``index_copy_`` into the same tensors): the decode,
        verify and draft graphs read the pools by address, so the next
        replay reads the migrated pages and nothing is captured again. A
        payload whose planes this pool lacks, or that lacks planes this
        pool has (an fp and an int8 replica), raises ``ValueError``."""
        self._ensure_pool()
        for name, attr in (("k", "_pk"), ("v", "_pv"),
                           ("sk", "_sk"), ("sv", "_sv")):
            mine = getattr(self, attr) is not None
            if mine != bool(payload.get(name)):
                raise ValueError(
                    f"payload {'lacks' if mine else 'carries'} {name!r} "
                    f"planes this engine {'holds' if mine else 'has none of'}"
                    " (kv_dtype mismatch across replicas?)")
        self._scatter_pages(self._page_index(pages), payload)
        for name, attr in (("k", "_pk"), ("v", "_pv"),
                           ("sk", "_sk"), ("sv", "_sv")):
            leaves = getattr(self, attr)
            if leaves is not None and any(
                    a is not b for a, b in
                    zip(self._place_migrated(leaves, name), leaves)):
                raise MXNetError(
                    "SlotDecoder: a migration must leave the pools where "
                    "they are: the captured graphs read them by address")

    def _page_index(self, pages):
        """Host page ids as an int64 index on the pool's device."""
        return torch.as_tensor(list(pages), dtype=torch.int64).to(
            self._device)

    def _gather_pages(self, idx):
        """The device half of `copy_pages_out`: the pages at ``idx`` of
        every plane, gathered into new tensors."""
        return {name: [pool.index_select(0, idx) for pool in leaves]
                for name, leaves in (("k", self._pk), ("v", self._pv),
                                     ("sk", self._sk), ("sv", self._sv))
                if leaves is not None}

    def _scatter_pages(self, idx, payload):
        """The device half of `copy_pages_in`: each payload plane written
        into the pool's pages at ``idx`` in place."""
        for name, leaves in (("k", self._pk), ("v", self._pv),
                             ("sk", self._sk), ("sv", self._sv)):
            if leaves is not None:
                for pool, blk in zip(leaves, payload[name]):
                    pool.index_copy_(0, idx, blk.to(pool.device, pool.dtype))

    def _place_migrated(self, leaves, name):  # noqa: ARG002
        """Placement seam after a migration's write: the base engine wrote
        its pools in place and keeps them (the graphs read them by
        address); the reference's sharded engine re-pins here, and a port
        of it must do so in place too."""
        return leaves

    def _refresh_params(self):
        """Whether the weights changed since the steps' programs were
        built (a parameter replaced by a new tensor: a new fingerprint).
        If so, the graphs are dropped here, so the next call of each step
        runs eagerly and the one after captures again, as `_run_step`
        would do at its next call anyway; a weight updated in place is
        read by the graphs as it is. The gateway's `hot_swap` calls it a
        replica at a time."""
        if not self._program_fp:
            return False
        fp = self._fingerprint()
        if all(v == fp for v in self._program_fp.values()):
            return False
        self._graphs.clear()
        self._program_fp = {name: None for name in self._program_fp}
        return True

    # -- the pool's reads and writes ----------------------------------------

    @staticmethod
    def _dequant_view(pool, scale, idx):
        """Pages ``idx`` of one layer's pool as real values (leading dims
        follow ``idx``): an fp pool gathers straight through, an int8 one
        multiplies by each (page, head) scale in f32."""
        v = pool[idx]
        if scale is not None:
            v = v.float() * scale[idx][..., None, None]
        return v

    def _write_token(self, pool, scale, wpage, woff, t):
        """Write one token's K or V ``t`` (S, H, d) of every slot at
        (``wpage``, ``woff``) in place. An int8 pool re-quantizes the
        whole written page under a grow-only scale: the new scale is
        max(old, amax / 127), the page's codes are rescaled by old / new
        and rounded, then the token is quantized into it."""
        if scale is None:
            pool[wpage, :, woff] = t.to(pool.dtype)
            return
        old = scale[wpage]                                   # (S, H)
        amax = t.abs().amax(dim=-1)                          # (S, H)
        new = torch.maximum(old, amax.clamp_min(1e-8) / 127.0)
        page = pool[wpage].float()                           # (S, H, pt, d)
        page = torch.clamp(
            torch.round(page * (old / new)[:, :, None, None]), -127, 127)
        tq, _ = quantize_symmetric(t, (), scale=new[:, :, None])
        rows = torch.arange(t.shape[0], device=t.device)
        page[rows, :, woff] = tq.float()
        pool[wpage] = page.to(torch.int8)
        scale[wpage] = new

    def _slot_layer(self, dec, blk, x, pools, table, wpage, woff, mask):
        """One layer of ``dec`` over T new rows a slot, the body of the
        decode (T = 1), verify (T = k + 1) and draft (T = 1, k times)
        steps: writes row i's K/V at (``wpage[:, i]``, ``woff[:, i]``)
        column by column (under int8 this order sets the page scales),
        gathers each slot's view through ``table`` and attends under
        ``mask`` (S, T, view) with f32 scores. ``x`` is (S, T, C)."""
        S, T, _ = x.shape
        pk, pv, sk, sv = pools
        q, k, v = dec._qkv(x, blk)                            # (S, T, H, d)
        H, d = q.shape[2], q.shape[3]
        for i in range(T):
            self._write_token(pk, sk, wpage[:, i], woff[:, i], k[:, i])
            self._write_token(pv, sv, wpage[:, i], woff[:, i], v[:, i])
        # per-slot logical view: (S, P, H, pt, d) -> (S, H, P * pt, d)
        vk = self._dequant_view(pk, sk, table).transpose(1, 2).reshape(
            S, H, -1, d)
        vv = self._dequant_view(pv, sv, table).transpose(1, 2).reshape(
            S, H, -1, d)
        s = torch.matmul(q.transpose(1, 2).float(),
                         vk.float().transpose(-1, -2)) / math.sqrt(d)
        s = s.masked_fill(~mask[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1).to(vv.dtype)
        o = torch.matmul(p, vv).transpose(1, 2).reshape(S, T, H * d)
        a = blk.attn
        o = F.linear(o.to(x.dtype), a.proj.weight, a.proj.bias)
        return dec._ffn(x + o, blk)

    # -- sampling -----------------------------------------------------------

    def _sample_slots(self, logits, key, temperature):
        """Next token per row of ``logits`` (rows, V): greedy argmax, or
        Gumbel-max over the temperature-scaled (rows,), optionally top-k
        truncated logits, the noise from the Philox words of ``key``."""
        if not self._do_sample:
            return logits.argmax(dim=-1)
        logits = logits.float() / temperature[:, None]
        idx = None
        if self._top_k is not None:
            logits, idx = torch.topk(logits, self._top_k, dim=-1)
        choice = (logits + _gumbel(logits.shape, key)).argmax(dim=-1)
        return choice if idx is None else idx.gather(-1, choice[:, None])[:, 0]

    # -- chunked prefill ----------------------------------------------------

    def _prefill_fn(self, tokens, pages_row, chunk_pages, t_start, t_len,
                    key, temperature, draft=False):
        """One chunk (``tokens`` (C,), padded to its bucket) of one slot,
        through the target (or, with ``draft``, the draft model into its
        own pools): writes its K/V pages, attends to the slot's view
        (prefix pages and itself) under the causal-with-offset mask, and
        returns the token sampled from row ``t_len - 1`` (a 1-element
        tensor)."""
        dec = self._draft_dec if draft else self._dec
        m = dec._model
        C = tokens.shape[0]
        pt, PT = self.page_tokens, self.view_tokens
        dev = tokens.device
        qpos = t_start + torch.arange(C, device=dev)
        x = (m.word_embed.weight[tokens]
             + m.position_embed[qpos.clamp(max=m.max_length - 1)])[None]
        # key j is visible to chunk row i iff j <= t_start + i: the prefix
        # pages, in-chunk causality, and no stale, trash or padding page
        mask = torch.arange(PT, device=dev)[None, :] <= qpos[:, None]
        # the chunk's own rows inside the view (a bucket may overshoot it)
        own = min(C, PT - t_start)
        for blk, (pk, pv, sk, sv) in zip(m.blocks, self._layer_pools(draft)):
            q, k, v = dec._qkv(x, blk)                       # (1, C, H, d)
            H, d = q.shape[2], q.shape[3]
            kp = k[0].reshape(C // pt, pt, H, d).transpose(1, 2)
            vp = v[0].reshape(C // pt, pt, H, d).transpose(1, 2)
            if sk is None:
                pk[chunk_pages] = kp
                pv[chunk_pages] = vp
            else:
                # whole chunk pages, one scale per (page, head)
                kq, ks = quantize_symmetric(kp, (2, 3))
                vq, vs = quantize_symmetric(vp, (2, 3))
                pk[chunk_pages], sk[chunk_pages] = kq, ks[:, :, 0, 0]
                pv[chunk_pages], sv[chunk_pages] = vq, vs[:, :, 0, 0]
            vk = self._dequant_view(pk, sk, pages_row).transpose(
                0, 1).reshape(H, PT, d)
            vv = self._dequant_view(pv, sv, pages_row).transpose(
                0, 1).reshape(H, PT, d)
            if sk is not None:
                # the chunk attends to its own K/V before quantization:
                # only the prefix pays for it
                vk[:, t_start:t_start + own] = k[0, :own].transpose(0, 1)
                vv[:, t_start:t_start + own] = v[0, :own].transpose(0, 1)
            # the reference's `_xla_attention`: scaled scores, masked to
            # finfo.min / 2, softmax in the scores' dtype
            s = torch.matmul(q[0].transpose(0, 1).to(vk.dtype),
                             vk.transpose(-1, -2)) * (1.0 / math.sqrt(d))
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min / 2)
            o = torch.matmul(torch.softmax(s, dim=-1), vv)   # (H, C, d)
            o = o.transpose(0, 1).reshape(1, C, H * d).to(x.dtype)
            a = blk.attn
            x = dec._ffn(x + F.linear(o, a.proj.weight, a.proj.bias), blk)
        # the chunk's last real row (padding is causally after it)
        logits = dec._logits(x[:, t_len - 1])                # (1, V)
        return self._sample_slots(logits, key, temperature)

    @torch.no_grad()
    def prefill_chunk_step(self, slot, chunk_tokens, t_start, key,
                           temperature=1.0):
        """Run one page-aligned prefill chunk for ``slot``.

        ``chunk_tokens`` is the host slice ``prompt[t_start:t_start+n]``
        with ``t_start`` a multiple of ``page_tokens`` (0 or the shared
        prefix's end). ``key`` is the step key's two words. Returns
        ``(first_token, bucket, pad)``: the sampled token is meaningful
        only on the prompt's final chunk. With a model draft, the draft
        prefills the same chunk into its own pools after the target (same
        pages: the table and allocator are shared), so drafting starts
        from a warm draft KV."""
        self._ensure_pool()
        pt = self.page_tokens
        if t_start % pt:
            raise ValueError(
                f"chunk start {t_start} is not page-aligned (page_tokens="
                f"{pt})")
        chunk = onp.asarray(chunk_tokens, onp.int64).reshape(-1)
        n = chunk.size
        bucket = bucket_chunk(n, self.chunk_buckets)
        pad = bucket - n
        if pad:
            chunk = onp.pad(chunk, (0, pad))
            PAD_TOKENS.inc(pad)
        # the chunk's pages, the trash page where the bucket overshoots
        # the slot's mapped range (pad-token K/V is discarded)
        first_page = t_start // pt
        row = self._table[slot].astype(onp.int64)
        chunk_pages = onp.zeros(bucket // pt, onp.int64)
        avail = row[first_page:first_page + chunk_pages.size]
        chunk_pages[:avail.size] = avail
        ints = torch.from_numpy(
            onp.concatenate([chunk, row, chunk_pages])).to(self._device)
        P = self.pages_per_slot
        k_dev = t_dev = None
        if self._do_sample:
            k_dev = torch.tensor(key, dtype=torch.int64, device=self._device)
            t_dev = torch.tensor([max(float(temperature), 1e-6)],
                                 dtype=torch.float32, device=self._device)
        args = (ints[:bucket], ints[bucket:bucket + P], ints[bucket + P:],
                int(t_start), n, k_dev, t_dev)
        fresh = bucket not in self._buckets_seen
        self._buckets_seen.add(bucket)
        t0 = time.perf_counter()
        first = self._prefill_fn(*args)
        if fresh:
            self._ledger("prefill", t0, args, bucket, first)
        if self._draft_dec is not None:
            t0 = time.perf_counter()
            out = self._prefill_fn(*args, draft=True)
            if fresh:
                self._ledger("draft_prefill", t0, args, bucket, out)
        return int(first[0]), bucket, pad

    def _ledger(self, kind, t0, args, bucket=None, out=None):
        """One program-ledger entry (`telemetry.compiles`) for a program
        this engine just built, its wall counted from ``t0``: a captured
        step, a CPU model's step under new weights, or a new prefill
        bucket's first eager run (``out``, its output, is waited for, so
        the wall covers the run). A dead branch while the ledger is
        off."""
        if _compiles.is_enabled():
            if out is not None:
                out.cpu()
            _compiles.record_compile(
                f"{self.census_name}.{kind}", time.perf_counter() - t0,
                args=args, bucket=bucket)

    # -- the replayed steps -------------------------------------------------

    def _decode_fn(self, table, step, temperature):
        """One decode step for every slot on the device inputs: ``table``
        (S, P) int64; ``step`` (3S + 2,) int64 holding last_tok, pos,
        active (0/1) and the key's two words; ``temperature`` (S,) f32.
        Writes the pools in place and returns the next token per slot (S,)
        int64 (inactive slots carry their last token). It syncs nothing
        with the host: this is the function the decode graph captures."""
        dec = self._dec
        m = dec._model
        S, pt = self.max_slots, self.page_tokens
        last_tok, pos = step[:S], step[S:2 * S]
        active = step[2 * S:3 * S] != 0
        key = step[3 * S:]
        x = (m.word_embed.weight[last_tok] + m.position_embed[pos])[:, None]
        # each slot writes at its own page and offset; free and
        # prefilling slots are redirected to the trash page
        rows = torch.arange(S, device=pos.device)
        wpage = torch.where(active, table[rows, pos // pt], 0)[:, None]
        woff = (pos % pt)[:, None]
        mask = (torch.arange(self.view_tokens, device=pos.device)[None, :]
                <= pos[:, None])[:, None]
        for blk, pools in zip(m.blocks, self._layer_pools()):
            x = self._slot_layer(dec, blk, x, pools, table, wpage, woff,
                                 mask)
        nxt = self._sample_slots(dec._logits(x[:, 0]), key, temperature)
        return torch.where(active, nxt, last_tok)

    def _spec_inputs(self, spec):
        """The verify and draft steps' device inputs out of ``spec``:
        tokens (S, k + 1), pos, active (bool) and limit (S,)."""
        S, K1 = self.max_slots, self.spec_k + 1
        n = S * K1
        return (spec[:n].view(S, K1), spec[n:n + S],
                spec[n + S:n + 2 * S] != 0, spec[n + 2 * S:])

    def _verify_fn(self, table, spec):
        """The verify step: one batched target pass over k + 1 rows a slot.
        Row i consumes token ``[last, d_1..d_k][i]`` at position ``pos +
        i``, writes its K/V to the slot's pages (rows past ``limit``, the
        slot's last page-mapped position, write to the trash page) and
        attends to positions ``<= pos + i``, so the pass equals k + 1
        sequential decode steps. Returns the greedy token per row (S, k +
        1) int64, an inactive slot's rows its own tokens. This is the
        function the verify graph captures."""
        dec = self._dec
        m = dec._model
        S, K1, pt = self.max_slots, self.spec_k + 1, self.page_tokens
        toks, pos, active, limit = self._spec_inputs(spec)
        dev = toks.device
        p_abs = pos[:, None] + torch.arange(K1, device=dev)      # (S, K1)
        x = (m.word_embed.weight[toks]
             + m.position_embed[p_abs.clamp(0, m.max_length - 1)])
        writable = active[:, None] & (p_abs <= limit[:, None])
        page = table.gather(1, (p_abs // pt).clamp(0, table.shape[1] - 1))
        wpage = torch.where(writable, page, 0)
        mask = (torch.arange(self.view_tokens, device=dev)[None, None, :]
                <= p_abs[:, :, None])                              # (S, K1, PT)
        for blk, pools in zip(m.blocks, self._layer_pools()):
            x = self._slot_layer(dec, blk, x, pools, table, wpage,
                                 p_abs % pt, mask)
        logits = dec._logits(x.reshape(S * K1, -1)).reshape(S, K1, -1)
        return torch.where(active[:, None], logits.argmax(dim=-1), toks)

    def _draft_fn(self, table, spec):
        """The draft step: k unrolled greedy decode steps of the draft
        model against its own pools, from each slot's last token at
        ``pos`` (the spec tokens' first column). Returns the drafts (S, k)
        int64. This is the function the draft graph captures."""
        dec = self._draft_dec
        m = dec._model
        S, pt = self.max_slots, self.page_tokens
        toks, pos, active, limit = self._spec_inputs(spec)
        dev = toks.device
        rows = torch.arange(S, device=dev)
        view = torch.arange(self.view_tokens, device=dev)
        cur, outs = toks[:, 0], []
        for i in range(self.spec_k):
            p_i = pos + i
            page = table[rows, (p_i // pt).clamp(0, table.shape[1] - 1)]
            wpage = torch.where(active & (p_i <= limit), page, 0)[:, None]
            mask = (view[None, :] <= p_i[:, None])[:, None]
            x = (m.word_embed.weight[cur]
                 + m.position_embed[p_i.clamp(0, m.max_length - 1)])[:, None]
            for blk, pools in zip(m.blocks, self._layer_pools(draft=True)):
                x = self._slot_layer(dec, blk, x, pools, table, wpage,
                                     (p_i % pt)[:, None], mask)
            cur = torch.where(active, dec._logits(x[:, 0]).argmax(dim=-1),
                              cur)
            outs.append(cur)
        return torch.stack(outs, dim=1)

    def _fingerprint(self):
        """The ``data_ptr`` of every parameter of the target and the draft
        model, walking the module trees anew (a replaced submodule is seen
        too) through the modules' own dicts: `Module.parameters()` costs
        ~0.3 ms a step at gpt2_small."""
        ptrs, stack = [], [self._dec._model]
        if self._draft_dec is not None \
                and self._draft_dec._model is not self._dec._model:
            stack.append(self._draft_dec._model)
        while stack:
            m = stack.pop()
            ptrs.extend(p.data_ptr() for p in m._parameters.values()
                        if p is not None)
            stack.extend(m._modules.values())
        return tuple(ptrs)

    def _load_step(self, last_tok, pos, active, key, temperature):
        """Copy the decode step's host inputs into its static device
        buffers (``copy_``, never a rebind); the table and the
        temperatures only when they changed. Returns the decode function's
        arguments."""
        S = self.max_slots
        h = self._step_host
        h[:S] = last_tok
        h[S:2 * S] = pos
        h[2 * S:3 * S] = active
        h[3 * S:] = key
        self._step_dev.copy_(torch.from_numpy(h))
        temp = onp.asarray(temperature, onp.float32).reshape(S)
        if self._temp_host is None or not onp.array_equal(temp,
                                                          self._temp_host):
            self._temp_host = temp.copy()
            self._temp_dev.copy_(torch.from_numpy(self._temp_host))
        return self._table_device(), self._step_dev, self._temp_dev

    def _load_spec(self, last_tok, drafts, pos, active, limit):
        """Copy the verify or draft step's host inputs into their static
        device buffer with one ``copy_``; ``drafts`` None leaves the draft
        columns as they are (the draft step reads only ``last_tok``).
        Returns the step function's arguments."""
        S, K1 = self.max_slots, self.spec_k + 1
        h = self._spec_host
        toks = h[:S * K1].reshape(S, K1)
        toks[:, 0] = last_tok
        if drafts is not None:
            toks[:, 1:] = drafts
        h[S * K1:S * K1 + S] = pos
        h[S * K1 + S:S * K1 + 2 * S] = active
        h[S * K1 + 2 * S:] = limit
        self._spec_dev.copy_(torch.from_numpy(h))
        return self._table_device(), self._spec_dev

    def _eager_on_side_stream(self, fn, args):
        """A fingerprint's first call of a step on the card: the step
        function run eagerly on a side stream, so what a step does once
        (kernel loads, cuBLAS handles) happens before the capture. The
        side stream is one per device, shared by every engine: cuBLAS
        keeps a workspace per stream for the process's life, so an
        engine of its own would leave one behind at each spawn of an
        elastic replica."""
        side = _side_stream(self._device)
        main = torch.cuda.current_stream(self._device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(*args)
        main.wait_stream(side)
        return out

    def _capture(self, name, fn, args):
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn(*args)
        except Exception as e:
            raise MXNetError(f"SlotDecoder: capturing the {name} step as a "
                             f"CUDA graph failed: {e}") from e
        self._graphs[name] = (graph, out)
        self.captures += 1
        self.captures_by_step[name] += 1
        self._builds += 1
        self._ledger(name, t0, args)

    def _run_step(self, name, args):
        """Run the step ``name`` ("decode", "verify", "draft") on its
        loaded device inputs: eagerly on a CPU model; on the card, eagerly
        at a new weight fingerprint, captured at the next call and
        replayed from then on. Returns the step's device output."""
        fn = getattr(self, f"_{name}_fn")
        fp = self._fingerprint()
        if self._device.type != "cuda":
            if fp == self._program_fp.get(name):
                return fn(*args)
            self._program_fp[name] = fp
            self._builds += 1
            t0 = time.perf_counter()
            out = fn(*args)
            self._ledger(name, t0, args)
            return out
        if fp != self._program_fp.get(name):
            # new weights (or a new pool): one eager step, then capture
            self._graphs.pop(name, None)
            self._program_fp[name] = fp
            with torch.cuda.device(self._device):
                return self._eager_on_side_stream(fn, args)
        if name not in self._graphs:
            with torch.cuda.device(self._device):
                self._capture(name, fn, args)
        graph, out = self._graphs[name]
        graph.replay()
        return out

    @torch.no_grad()
    def decode_step(self, last_tok, pos, active, key, temperature):
        """One decode step for every decode-active slot. ``last_tok``,
        ``pos``, ``active`` and ``temperature`` are host arrays of shape
        ``(max_slots,)`` owned by the scheduler, ``key`` the step key's two
        words; slots still mid-prefill must have ``active=False`` (their
        writes go to the trash page). Returns the next token per slot as
        host int32 numpy: the one host sync of the step."""
        self._ensure_pool()
        args = self._load_step(last_tok, pos, active, key, temperature)
        nxt = self._run_step("decode", args)
        return nxt.cpu().numpy().astype(onp.int32)

    # -- speculative decoding -----------------------------------------------

    def spec_propose(self, seqs):
        """Host n-gram drafts: ``seqs`` is a per-slot list (None for slots
        not decoding) of 1-D prompt + generated token arrays. Returns
        ``(max_slots, spec_k)`` int32 numpy. No device work: the n-gram
        draft's whole cost is this call."""
        out = onp.zeros((self.max_slots, self.spec_k), onp.int32)
        for s, seq in enumerate(seqs):
            if seq is not None:
                out[s] = self._ngram.propose(seq)
        return out

    @torch.no_grad()
    def spec_draft_step(self, last_tok, pos, active, limit):
        """Run the draft model's k-step draft for every slot; returns the
        drafted tokens ``(max_slots, spec_k)`` as host int32 numpy."""
        self._ensure_pool()
        args = self._load_spec(last_tok, None, pos, active, limit)
        toks = self._run_step("draft", args)
        return toks.cpu().numpy().astype(onp.int32)

    @torch.no_grad()
    def spec_verify_step(self, last_tok, drafts, pos, active, limit):
        """Verify ``drafts`` (host ``(max_slots, spec_k)``) for every
        decoding slot in one batched target pass. Returns the greedy target
        token per row as host int32 numpy ``(max_slots, spec_k + 1)``: row
        ``i`` is the token the target emits after consuming ``[last,
        d_1..d_i]``; the scheduler accepts the longest drafted prefix
        matching rows ``0..m-1`` plus row ``m`` as the bonus token."""
        self._ensure_pool()
        if not self._spec_gauge:
            self._register_spec_gauge()
        args = self._load_spec(last_tok, drafts, pos, active, limit)
        tgt = self._run_step("verify", args)
        return tgt.cpu().numpy().astype(onp.int32)

    def spec_count(self, drafted, accepted):
        """Scheduler callback: fold one slot-round's drafted and accepted
        token counts into the engine's lifetime acceptance stats."""
        self._spec_drafted += int(drafted)
        self._spec_accepted += int(accepted)

    def spec_stats(self):
        """Lifetime speculative-decoding stats: ``{"k", "draft",
        "drafted", "accepted", "accept_rate"}``."""
        drafted = self._spec_drafted
        return {"k": self.spec_k, "draft": self.draft_kind,
                "drafted": drafted, "accepted": self._spec_accepted,
                "accept_rate": (self._spec_accepted / drafted)
                if drafted else None}

    def _register_spec_gauge(self):
        """The pull gauge of the lifetime acceptance rate, labelled with
        ``census_name``; registered at the first verify, so a caller that
        renames the engine first is seen. Weakly bound, like the
        occupancy probe."""
        self._spec_gauge = True
        ref = weakref.ref(self)

        def probe():
            eng = ref()
            if eng is None or not eng._spec_drafted:
                return None
            return eng._spec_accepted / eng._spec_drafted

        registry.register_pull_gauge(
            "mx_serve_spec_accept_rate", probe,
            "accepted draft tokens / drafted tokens since engine start "
            "[0, 1] (speculative decoding)",
            labels={"model": self.census_name})

    # -- debug / tests ------------------------------------------------------

    @torch.no_grad()
    def slot_kv(self, slot, n_tokens):
        """Host f32 copies ``(L, H, n_tokens, d)`` of a slot's first
        ``n_tokens`` of K and V (dequantized under int8), for parity
        checks (not a hot path)."""
        self._ensure_pool()
        idx = torch.from_numpy(self._table[slot].astype(onp.int64)).to(
            self._device)
        outs = []
        for pools, scales in ((self._pk, self._sk), (self._pv, self._sv)):
            views = []
            for li, pool in enumerate(pools):
                v = self._dequant_view(
                    pool, None if scales is None else scales[li], idx)
                P, H, pt, d = v.shape
                views.append(v.transpose(0, 1).reshape(H, P * pt, d)
                             [:, :n_tokens])
            outs.append(torch.stack(views).float().cpu().numpy())
        return outs[0], outs[1]

    def hbm_crosscheck(self, mesh=None):  # noqa: ARG002
        """The reference compares this engine's census bytes (its
        ``kv_pool`` and ``params`` owners, `telemetry.hbm`) with
        shardcheck's SC006 static estimate of the decode program. The
        census is here; shardcheck is not ported, so this raises
        `MXNetError`."""
        raise MXNetError(
            "SlotDecoder.hbm_crosscheck needs shardcheck's SC006 static "
            "estimate, which is not ported yet (ROADMAP.md §1 item 10); "
            "telemetry.hbm.census() gives the census half")

    def xla_program_count(self):
        """The programs this engine built, under the reference's name (its
        recompile gate asserts the count stays flat in steady state): the
        distinct prefill chunk buckets seen (twice with a model draft,
        which prefills each chunk too), plus each step (decode, verify,
        draft) once per build. On the card a build is a captured graph (a
        new pool or new weights capture again); on a CPU model, where
        nothing is captured, the first call under a new weight
        fingerprint."""
        prefills = 2 if self._draft_dec is not None else 1
        return prefills * len(self._buckets_seen) + self._builds


_SIDE_STREAMS = {}            # device index -> the engines' side stream


def _side_stream(device):
    """The side stream of the engines' eager first steps on ``device``."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _SIDE_STREAMS.get(idx)
    if stream is None:
        stream = _SIDE_STREAMS[idx] = torch.cuda.Stream(idx)
    return stream


def _occupancy_probe(allocator):
    """Weakly bound pull probe for the page-occupancy gauge (engines come
    and go; a dead allocator must not pin memory or poison the
    collector)."""
    ref = weakref.ref(allocator)

    def probe():
        a = ref()
        if a is None or a.usable_pages == 0:
            return None
        return a.used_pages / a.usable_pages

    return probe
