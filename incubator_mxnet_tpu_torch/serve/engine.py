"""Paged slot-cache decoding, the device half of `serve` (port of
`incubator_mxnet_tpu/serve/engine.py`: `PagePoolExhausted` :137,
`PageAllocator` :144, `PrefixCache` :232, `SlotDecoder` :361), in the
reference's base configuration: a KV pool in the weights' dtype, no
speculative decoding, one card.

- **page pool**: per layer, one K and one V tensor of shape ``(n_pages,
  H, page_tokens, d)``, allocated once and written in place. Page 0 is
  the *trash* page: unallocated page-table entries and the writes of
  inactive slots land there, and no mask ever admits it.
- **page table**: a host ``(max_slots, pages_per_slot)`` array mapping
  each slot's token range to pool pages, copied into a device buffer only
  when an allocation changed it. Decode gathers each slot's view of the
  pool through its table row; prefill writes whole pages.
- **allocator and prefix cache**: `PageAllocator` (host free list and
  refcounts; the loud `PagePoolExhausted`, nothing referenced is ever
  evicted) and `PrefixCache` (digest of a page-aligned token prefix ->
  its pages), so a shared system prompt is prefilled once and its pages
  attached read-only to every later request that starts with it.

Two functions run against the pool:

- **chunked prefill** (`SlotDecoder.prefill_chunk_step`, eager): one
  page-aligned chunk of one request's prompt, padded to a chunk bucket
  (`models.decoding.chunk_buckets`). It embeds the chunk at its true
  positions, writes its K/V pages, attends its queries to the slot's
  gathered view under the causal-with-offset mask (key j is visible to
  row i iff j <= t_start + i; K1's causal mask is aligned at query 0 and
  cannot express it) and samples a first token from the chunk's last
  real row: one host sync, the token.
- **decode** (`SlotDecoder.decode_step`): one token for every slot. Each
  slot writes its new K/V at ``table[s, pos // page_tokens]``, offset
  ``pos % page_tokens`` (inactive slots write to the trash page), gathers
  its view, attends under ``key <= pos`` in f32 and samples. On a CUDA
  model the step is **one CUDA graph**, captured once over the static
  pool and input buffers and replayed every step; on a CPU model the same
  function runs eagerly.

Every LayerNorm of both is the LayerNorm kernel (K4), through
`models.decoding.GPTDecoder`'s layer helpers. The int8 pool, speculative
decoding, the disaggregation hand-off and the sharding and HBM methods of
the reference are not ported yet (`ROADMAP.md` §1 item 2).

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
import weakref

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..models.decoding import GPTDecoder, bucket_chunk, chunk_buckets
from ..ops import _philox
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
_NOT_PORTED = "is not ported yet (ROADMAP.md §1 item 2)"

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
    kv_dtype : "fp"
        KV storage (default ``MXNET_SERVE_KV_DTYPE`` or "fp": the weights'
        dtype). "int8" raises `MXNetError`: it is not ported yet.
    prefix_reuse : bool
        Arm the shared-prefix cache (default True).
    do_sample / top_k
        Sampling mode, fixed per engine; the temperature stays a per-slot
        runtime input. Sampling is Gumbel-max on the Philox words of the
        step's key.
    spec_k : int
        Speculative decoding draft length (default ``MXNET_SERVE_SPEC_K``
        or 0). A value above 0 raises `MXNetError`: not ported yet.

    On a CUDA model the decode step is captured as a CUDA graph: a weight
    fingerprint's first step runs eagerly on a side stream (kernel loads,
    cuBLAS handles), its second captures the step and replays it, and
    every later step copies its inputs into the graph's static buffers
    and replays. The capture runs in whichever thread steps the engine
    (the driver thread of `ServeEngine.start`), in the
    ``"thread_local"`` capture mode, so other threads' CUDA calls do not
    invalidate it. A capture that fails raises `MXNetError`; nothing falls
    back to eager steps on the card. The graph reads the weights by
    address: a weight updated in place is seen, and one replaced by a new
    tensor changes the fingerprint (the ``data_ptr`` of every parameter),
    which drops the graph so the next steps capture again. The prefix
    cache keeps pages prefilled under earlier weights, as the reference's
    does (its hot swap lets in-flight KV continue under new weights): a
    caller that swaps weights and wants fresh prefixes clears
    ``prefix_cache``.
    """

    def __init__(self, source, max_slots=8, max_len=None, page_tokens=None,
                 prefill_chunk=None, n_pages=None, kv_dtype=None,
                 prefix_reuse=True, do_sample=False, top_k=None,
                 spec_k=None):
        if isinstance(source, GPTDecoder):
            self._dec = source
        elif hasattr(source, "blocks") and hasattr(source, "position_embed"):
            self._dec = GPTDecoder(source)
        else:
            raise TypeError(
                "SlotDecoder needs a GPTDecoder or a GPT-shaped model "
                f"(blocks + position_embed), got {type(source).__name__}")
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
        if kv_dtype == "int8":
            raise MXNetError(f"the int8 KV pool {_NOT_PORTED}")
        self.kv_dtype = kv_dtype
        spec_k = int(spec_k) if spec_k is not None else \
            env_int("MXNET_SERVE_SPEC_K", 0)
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k:
            raise MXNetError(f"speculative decoding (spec_k={spec_k}) "
                             f"{_NOT_PORTED}")
        self.spec_k = 0

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

        # host page table; its device copy is refreshed only when an
        # allocation changed it
        self._table = onp.zeros((self.max_slots, self.pages_per_slot),
                                onp.int32)
        self._table_dirty = True
        # the step's host inputs, uploaded with one copy: last_tok, pos,
        # active (0/1) and the step key's two words
        self._step_host = onp.zeros(3 * self.max_slots + 2, onp.int64)
        self._temp_host = None
        # per-layer pools and the device buffers the decode graph reads,
        # allocated together (`_ensure_pool`) and dropped together
        self._pk = self._pv = None
        self._table_dev = self._step_dev = self._temp_dev = None
        self._buckets_seen = set()
        self._decode_builds = 0
        self._program_fp = None     # weight fingerprint of the decode program
        self._graph = self._graph_out = None
        self._side = None
        self.captures = 0           # decode graphs captured (card only)

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

    def _make_pools(self):
        """Per-layer page pools: tuples of L tensors ``(n_pages, H,
        page_tokens, d)`` in the weights' dtype on the model's device."""
        dec = self._dec
        blocks = dec._model.blocks
        H = dec._n_heads
        shape = (self.n_pages, H, self.page_tokens, dec._units // H)
        dtype = blocks[0].attn.qkv.weight.dtype
        pk = tuple(torch.zeros(shape, dtype=dtype, device=self._device)
                   for _ in blocks)
        pv = tuple(torch.zeros(shape, dtype=dtype, device=self._device)
                   for _ in blocks)
        return pk, pv

    def _ensure_pool(self):
        if self._pk is not None:
            return
        self._pk, self._pv = self._make_pools()
        dev, S = self._device, self.max_slots
        self._table_dev = torch.zeros((S, self.pages_per_slot),
                                      dtype=torch.int64, device=dev)
        self._step_dev = torch.zeros(3 * S + 2, dtype=torch.int64,
                                     device=dev)
        self._temp_dev = torch.ones(S, dtype=torch.float32, device=dev)
        self._temp_host = None
        self._table_dirty = True

    def release(self):
        """Drop the device pool and the decode graph with it (shutdown);
        the next prefill reallocates and the decode step captures again."""
        self._pk = self._pv = None
        self._table_dev = self._step_dev = self._temp_dev = None
        self._graph = self._graph_out = None
        self._program_fp = None
        self._table_dirty = True

    @property
    def cache_bytes(self):
        """Device bytes held by the KV pools, 0 if released."""
        if self._pk is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in self._pk + self._pv)

    @property
    def kv_bytes_per_slot(self):
        """Resident pool bytes per decode slot."""
        if self._pk is None:
            return 0
        return self.cache_bytes / self.max_slots

    @property
    def page_bytes(self):
        """Bytes one pool page holds across all layers (K + V), from the
        shapes, so it needs no allocated pool."""
        dec = self._dec
        blocks = dec._model.blocks
        H = dec._n_heads
        itemsize = blocks[0].attn.qkv.weight.element_size()
        return len(blocks) * 2 * H * self.page_tokens * (
            dec._units // H) * itemsize

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
                    key, temperature):
        """One chunk (``tokens`` (C,), padded to its bucket) of one slot:
        writes its K/V pages, attends to the slot's view (prefix pages and
        itself) under the causal-with-offset mask, and returns the token
        sampled from row ``t_len - 1`` (a 1-element tensor)."""
        dec = self._dec
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
        for blk, pk, pv in zip(m.blocks, self._pk, self._pv):
            q, k, v = dec._qkv(x, blk)                       # (1, C, H, d)
            H, d = q.shape[2], q.shape[3]
            pk[chunk_pages] = k[0].reshape(C // pt, pt, H, d).transpose(1, 2)
            pv[chunk_pages] = v[0].reshape(C // pt, pt, H, d).transpose(1, 2)
            vk = pk[pages_row].transpose(0, 1).reshape(H, PT, d)
            vv = pv[pages_row].transpose(0, 1).reshape(H, PT, d)
            # the reference's `_xla_attention`: scaled scores, masked to
            # finfo.min / 2, softmax in the scores' dtype
            s = torch.matmul(q[0].transpose(0, 1), vk.transpose(-1, -2)) \
                * (1.0 / math.sqrt(d))
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min / 2)
            o = torch.matmul(torch.softmax(s, dim=-1), vv)   # (H, C, d)
            o = o.transpose(0, 1).reshape(1, C, H * d)
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
        only on the prompt's final chunk."""
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
        self._buckets_seen.add(bucket)
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
        first = self._prefill_fn(ints[:bucket], ints[bucket:bucket + P],
                                 ints[bucket + P:], int(t_start), n, k_dev,
                                 t_dev)
        return int(first[0]), bucket, pad

    # -- decode -------------------------------------------------------------

    def _decode_layer_step(self, blk, x, pk, pv, table, wpage, woff, mask):
        """One layer of the single-token decode body for every slot: writes
        each slot's K/V at (``wpage``, ``woff``) of the layer's pools
        ``pk``/``pv``, gathers each slot's view through ``table`` and
        attends under ``mask`` with f32 scores."""
        dec = self._dec
        S = self.max_slots
        q, k, v = dec._qkv(x, blk)                            # (S, 1, H, d)
        H, d = q.shape[2], q.shape[3]
        pk[wpage, :, woff] = k[:, 0]
        pv[wpage, :, woff] = v[:, 0]
        # per-slot logical view: (S, P, H, pt, d) -> (S, H, P * pt, d)
        vk = pk[table].transpose(1, 2).reshape(S, H, -1, d)
        vv = pv[table].transpose(1, 2).reshape(S, H, -1, d)
        s = torch.matmul(q.transpose(1, 2).float(),
                         vk.float().transpose(-1, -2)) / math.sqrt(d)
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1).to(vv.dtype)
        o = torch.matmul(p, vv).transpose(1, 2).reshape(S, 1, H * d)
        a = blk.attn
        return dec._ffn(x + F.linear(o, a.proj.weight, a.proj.bias), blk)

    def _decode_fn(self, table, step, temperature):
        """One decode step for every slot on the device inputs: ``table``
        (S, P) int64; ``step`` (3S + 2,) int64 holding last_tok, pos,
        active (0/1) and the key's two words; ``temperature`` (S,) f32.
        Writes the pools in place and returns the next token per slot (S,)
        int64 (inactive slots carry their last token). It syncs nothing
        with the host: this is the function the CUDA graph captures."""
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
        wpage = torch.where(active, table[rows, pos // pt], 0)
        woff = pos % pt
        mask = torch.arange(self.view_tokens,
                            device=pos.device)[None, :] <= pos[:, None]
        for blk, pk, pv in zip(m.blocks, self._pk, self._pv):
            x = self._decode_layer_step(blk, x, pk, pv, table, wpage, woff,
                                        mask)
        nxt = self._sample_slots(dec._logits(x[:, 0]), key, temperature)
        return torch.where(active, nxt, last_tok)

    def _fingerprint(self):
        """The ``data_ptr`` of every parameter, walking the module tree
        anew (a replaced submodule is seen too) through the modules' own
        dicts: `Module.parameters()` costs ~0.3 ms a step at gpt2_small."""
        ptrs, stack = [], [self._dec._model]
        while stack:
            m = stack.pop()
            ptrs.extend(p.data_ptr() for p in m._parameters.values()
                        if p is not None)
            stack.extend(m._modules.values())
        return tuple(ptrs)

    def _load_step(self, last_tok, pos, active, key, temperature):
        """Copy the step's host inputs into the static device buffers
        (``copy_``, never a rebind); the table and the temperatures only
        when they changed. Returns the decode function's arguments."""
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

    def _eager_on_side_stream(self, args):
        """A fingerprint's first step on the card: the decode function run
        eagerly on a side stream, so what a step does once (kernel loads,
        cuBLAS handles) happens before the capture."""
        if self._side is None:
            self._side = torch.cuda.Stream(self._device)
        main = torch.cuda.current_stream(self._device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = self._decode_fn(*args)
        main.wait_stream(self._side)
        return out

    def _capture(self, args):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._decode_fn(*args)
        except Exception as e:
            raise MXNetError(f"SlotDecoder: capturing the decode step as a "
                             f"CUDA graph failed: {e}") from e
        self._graph, self._graph_out = graph, out
        self.captures += 1
        self._decode_builds += 1

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
        fp = self._fingerprint()
        if self._device.type != "cuda":
            if fp != self._program_fp:
                self._program_fp = fp
                self._decode_builds += 1
            nxt = self._decode_fn(*args)
        elif fp != self._program_fp:
            # new weights (or a new pool): one eager step, then capture
            self._graph = self._graph_out = None
            self._program_fp = fp
            with torch.cuda.device(self._device):
                nxt = self._eager_on_side_stream(args)
        else:
            if self._graph is None:
                with torch.cuda.device(self._device):
                    self._capture(args)
            self._graph.replay()
            nxt = self._graph_out
        return nxt.cpu().numpy().astype(onp.int32)

    # -- debug / tests ------------------------------------------------------

    @torch.no_grad()
    def slot_kv(self, slot, n_tokens):
        """Host f32 copies ``(L, H, n_tokens, d)`` of a slot's first
        ``n_tokens`` of K and V, for parity checks (not a hot path)."""
        self._ensure_pool()
        idx = torch.from_numpy(self._table[slot].astype(onp.int64)).to(
            self._device)
        outs = []
        for pools in (self._pk, self._pv):
            views = []
            for pool in pools:
                v = pool[idx]                                # (P, H, pt, d)
                P, H, pt, d = v.shape
                views.append(v.transpose(0, 1).reshape(H, P * pt, d)
                             [:, :n_tokens])
            outs.append(torch.stack(views).float().cpu().numpy())
        return outs[0], outs[1]

    def xla_program_count(self):
        """The programs this engine built, under the reference's name (its
        recompile gate asserts the count stays flat in steady state): the
        distinct prefill chunk buckets seen, plus the decode program once
        per build. On the card a build is a captured decode graph (a new
        pool or new weights capture again); on a CPU model, where nothing
        is captured, the first step under a new weight fingerprint."""
        return len(self._buckets_seen) + self._decode_builds


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
