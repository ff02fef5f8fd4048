"""Prefix cache: refcounted page-level KV reuse across requests.

At millions-of-users scale most prefill work is redundant — shared
system prompts, few-shot templates, and multi-turn history repeat
across requests.  The paged KV plane makes reuse cheap: a page is
already the unit of sharing, so a request whose prompt starts with an
already-computed prefix can point its page table at the cached pages
and prefill only the uncached suffix.

Design (engine plane, :class:`PrefixCache`):

- **Content keys** are a *chained* blake2b digest over token-id blocks
  at page granularity: ``key_k = H(tokens[0 : (k+1) * page_size])``
  computed incrementally.  Chaining makes a key position- and
  prefix-dependent by construction, so two prompts share page ``k``
  iff they agree on ALL tokens up to and including that page — exactly
  the condition under which the K/V contents are identical.
- **Refcounts** pin shared pages: ``lookup`` increments per hit page,
  ``release_page`` (called by ``PagedKVManager.release`` for every
  page a retiring slot holds) decrements.  A page with refs > 0 is
  pinned — the allocator never sees it.  At refs == 0 the page moves
  to an LRU list: contents stay resident (a future lookup revives it)
  but the page is *reclaimable* — ``evict`` returns it to the
  ``PageAllocator`` free list when the pool runs dry or the cache's
  own ``max_pages`` budget is exceeded.
- **Copy-on-write at the first divergent token** is achieved
  structurally: a lookup only ever matches *full* pages strictly
  inside the prompt (capped at ``(l_in - 1) // page_size`` pages, so
  at least one prompt token always re-prefills and yields the
  first-token logits).  The first divergent token therefore lands in
  a freshly-allocated private page at a page-aligned boundary —
  writes never touch a shared page, which is what CoW must guarantee.
- **Publish** happens at prefill completion: the slot's full-page
  prefix span is registered under its chained keys with refs = 1
  (held by the publishing slot).  Pages that came *from* the cache
  (the slot's own hit span) are already registered; duplicate content
  computed concurrently by another slot stays private.

The sim plane mirrors hit/miss accounting with
:class:`SimPrefixIndex` — no token ids exist there, so identity is a
``(prefix_group, prefix_len)`` pair carried by the workload generator
(:func:`repro_torch.serving.workload.shared_prefix_workload`), with the same
page-aligned hit rule and LRU-by-group eviction.

A copy of ``repro/serving/prefix_cache.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np


def page_keys(token_ids, page_size: int, n_pages: int) -> list[bytes]:
    """Chained content keys for the first ``n_pages`` full pages of a
    prompt.  ``keys[k]`` digests tokens ``[0, (k+1) * page_size)`` —
    prefix-dependent, so equal keys imply identical K/V contents at
    identical absolute positions."""
    if n_pages <= 0:
        return []
    arr = np.ascontiguousarray(
        np.asarray(token_ids[: n_pages * page_size], dtype=np.int32)
    )
    h = hashlib.blake2b(digest_size=16)
    keys: list[bytes] = []
    for k in range(n_pages):
        h.update(arr[k * page_size: (k + 1) * page_size].tobytes())
        keys.append(h.digest())
    return keys


class PrefixCache:
    """Hash-indexed store of immutable prefix pages over a
    :class:`~repro_torch.serving.kv_manager.PageAllocator`.

    The cache never owns device memory — it tracks *which* pool pages
    hold published prefix content and arbitrates their lifetime
    between sharers (refcounts) and the allocator (LRU eviction).
    """

    def __init__(self, allocator, page_size: int,
                 max_pages: Optional[int] = None):
        if max_pages is not None and max_pages <= 0:
            raise ValueError("max_pages must be positive (None = bound "
                             "only by the page pool)")
        self.alloc = allocator
        self.page_size = page_size
        self.max_pages = max_pages
        self._index: dict[bytes, int] = {}        # content key -> page id
        self._entries: dict[int, list] = {}       # page id -> [key, refs]
        # refs-0 pages, least-recently-released first (eviction order);
        # contents stay resident until evicted, so a later lookup revives
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # telemetry
        self.n_lookups = 0
        self.n_hit_tokens = 0
        self.n_published = 0
        self.n_evicted = 0

    # -- introspection -------------------------------------------------------
    @property
    def n_cached(self) -> int:
        return len(self._entries)

    @property
    def n_reclaimable(self) -> int:
        """Cached pages with no sharers — reclaimable by ``evict``."""
        return len(self._lru)

    def is_cached(self, page: int) -> bool:
        return page in self._entries

    def refs(self, page: int) -> int:
        e = self._entries.get(page)
        return e[1] if e is not None else 0

    def stats(self) -> dict:
        return {
            "n_lookups": self.n_lookups,
            "n_hit_tokens": self.n_hit_tokens,
            "n_published": self.n_published,
            "n_evicted": self.n_evicted,
            "n_cached": self.n_cached,
            "n_reclaimable": self.n_reclaimable,
        }

    # -- the hit path --------------------------------------------------------
    def max_hit_pages(self, n_tokens: int) -> int:
        """Longest hit allowed for an ``n_tokens`` prompt: full pages
        strictly inside it, so >= 1 token always re-prefills (the
        first-token logits must come from somewhere) and the first
        private write lands page-aligned past the shared span."""
        return max(0, (n_tokens - 1) // self.page_size)

    def peek(self, token_ids) -> int:
        """Hit length (tokens) a ``lookup`` would return — read-only,
        no pinning.  The Dispatcher's Eq. 5 admission budget charges
        ``l_in - peek(...)``."""
        n = self.max_hit_pages(len(token_ids))
        hit = 0
        for key in page_keys(token_ids, self.page_size, n):
            if key not in self._index:
                break
            hit += self.page_size
        return hit

    def lookup(self, token_ids) -> tuple[list[int], int]:
        """Pin the longest cached prefix of ``token_ids``; returns
        ``(page_ids, hit_tokens)``.  Every returned page's refcount is
        incremented — the caller installs them in a slot's page table
        and releases via :meth:`release_page` when the slot retires."""
        self.n_lookups += 1
        n = self.max_hit_pages(len(token_ids))
        pages: list[int] = []
        for key in page_keys(token_ids, self.page_size, n):
            p = self._index.get(key)
            if p is None:
                break
            e = self._entries[p]
            e[1] += 1
            if e[1] == 1:           # revived from the reclaimable list
                self._lru.pop(p, None)
            pages.append(p)
        hit = len(pages) * self.page_size
        self.n_hit_tokens += hit
        return pages, hit

    # -- the publish path ----------------------------------------------------
    def publish(self, slot_pages: list[int], token_ids) -> int:
        """Register a prefill-complete slot's full-page prefix span.

        Newly-registered pages get refs = 1 (held by the publishing
        slot; its ``release_page`` at retirement drops them to the LRU
        list).  Pages already cache-owned (the slot's own hit span)
        and content another slot published concurrently are skipped —
        the latter stays a private page.  Returns pages newly
        published."""
        n = min(len(token_ids) // self.page_size, len(slot_pages))
        new = 0
        for k, key in enumerate(page_keys(token_ids, self.page_size, n)):
            p = slot_pages[k]
            if p in self._entries:
                continue            # already shared (came from lookup)
            if key in self._index:
                continue            # duplicate content: keep private
            if (self.max_pages is not None
                    and len(self._entries) >= self.max_pages
                    and not self._evict_one()):
                break               # budget full of pinned pages
            self._index[key] = p
            self._entries[p] = [key, 1]
            new += 1
        self.n_published += new
        return new

    # -- lifetime ------------------------------------------------------------
    def release_page(self, page: int) -> bool:
        """One sharer of ``page`` is gone.  True if the page is
        cache-owned (the caller must NOT free it to the allocator);
        False means the page is private and the caller frees it."""
        e = self._entries.get(page)
        if e is None:
            return False
        assert e[1] > 0, f"refcount underflow on page {page}"
        e[1] -= 1
        if e[1] == 0:
            self._lru[page] = None  # most-recently-released at the end
        return True

    def _evict_one(self) -> bool:
        if not self._lru:
            return False
        p, _ = self._lru.popitem(last=False)
        key, refs = self._entries.pop(p)
        assert refs == 0, f"evicting pinned page {p}"
        del self._index[key]
        self.alloc.free([p])
        self.n_evicted += 1
        return True

    def evict(self, n: int) -> int:
        """Reclaim up to ``n`` unreferenced cached pages into the
        allocator's free list (LRU first); returns pages freed."""
        freed = 0
        while freed < n and self._evict_one():
            freed += 1
        return freed


class SimPrefixIndex:
    """Sim-plane mirror of the prefix cache: cluster-shared hit/miss
    accounting keyed by ``(prefix_group, prefix_len)`` instead of
    token content (the simulator has no token ids).

    Semantics match the engine cache: hits are page-aligned and capped
    so >= 1 token always prefills; a group's cached length only grows
    (agent loops extend their history); groups with in-flight sharers
    are pinned against eviction; capacity is enforced LRU-by-group.
    """

    def __init__(self, page_size: int = 16,
                 capacity_pages: Optional[int] = None):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = page_size
        self.capacity_pages = capacity_pages
        self._cached: "OrderedDict[int, int]" = OrderedDict()  # group -> toks
        self._pins: dict[int, int] = {}     # group -> in-flight sharers
        self._rids: dict[int, int] = {}     # rid -> group (release key)
        self.n_lookups = 0
        self.n_hit_tokens = 0
        self.n_evicted = 0

    def _aligned(self, n_tokens: int) -> int:
        return (n_tokens // self.page_size) * self.page_size

    def peek(self, r) -> int:
        """Hit length (tokens) for request ``r`` — read-only."""
        if r.prefix_group is None:
            return 0
        cached = self._cached.get(r.prefix_group, 0)
        cap = self._aligned(max(r.l_in - 1, 0))
        return min(self._aligned(min(cached, r.prefix_len)), cap)

    def acquire(self, r) -> int:
        """Pin ``r``'s group and return the hit length; called at the
        first prefill touch (mirrors the engine's lookup-at-admission).
        """
        self.n_lookups += 1
        hit = self.peek(r)
        g = r.prefix_group
        if g is not None:
            self._pins[g] = self._pins.get(g, 0) + 1
            self._rids[r.rid] = g
            if g in self._cached:
                self._cached.move_to_end(g)
        self.n_hit_tokens += hit
        return hit

    def publish(self, r) -> None:
        """Prefill complete: the group's cached span grows to the
        page-aligned shared-prefix length of ``r``'s prompt."""
        g = r.prefix_group
        if g is None:
            return
        n = self._aligned(min(r.prefix_len, r.l_in))
        if n > self._cached.get(g, 0):
            self._cached[g] = n
        if g in self._cached:
            self._cached.move_to_end(g)
        self._evict_to_capacity()

    def release(self, rid: int) -> None:
        """Request ``rid`` left the plane (finished / freed); unpin its
        group.  Cluster-shared, so this works across a P/D migration —
        whichever worker finishes the request releases the same pin."""
        g = self._rids.pop(rid, None)
        if g is None:
            return
        left = self._pins.get(g, 0) - 1
        if left <= 0:
            self._pins.pop(g, None)
        else:
            self._pins[g] = left

    def _evict_to_capacity(self) -> None:
        if self.capacity_pages is None:
            return
        total = sum(v // self.page_size for v in self._cached.values())
        for g in list(self._cached):
            if total <= self.capacity_pages:
                break
            if self._pins.get(g, 0):
                continue            # in-flight sharers: pinned
            total -= self._cached.pop(g) // self.page_size
            self.n_evicted += 1

    def stats(self) -> dict:
        return {
            "n_lookups": self.n_lookups,
            "n_hit_tokens": self.n_hit_tokens,
            "n_evicted": self.n_evicted,
            "n_groups": len(self._cached),
        }
