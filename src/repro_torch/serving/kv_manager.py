"""KV cache management for the port's engine (counterpart of
``repro/serving/kv_manager.py``, paged plane).

A pool of fixed-size pages is shared by all sequences.
:class:`PageAllocator` hands out page ids from a free list;
:class:`PagedKVManager` keeps per-slot page tables (logical position
``t`` of slot ``b`` lives at page ``table[b, t // page_size]``, offset
``t % page_size``) and grows / reclaims them as requests prefill,
decode and retire.  The allocator and tables are host-side numpy, as in
the JAX package; :meth:`PagedKVManager.device_table` hands the table to
the model as a torch tensor.  Prefix caching and speculative rollback
(``truncate``) come with their ROADMAP item.

On the slot plane each sequence owns one batch row of every cache
leaf: :func:`insert_rows` copies a prefill's rows in and
:func:`clear_rows` wipes a retired row, both in place.

For a P/D hand-off, :func:`gather_slot_kv` linearizes one sequence's
pages through the page-gather kernel (one launch per pool, all layers
at once) and copies out its slot's row of every per-slot leaf (Mamba-2
conv and SSM state); :func:`scatter_slot_kv` installs both on the
destination, the pages with ``index_copy_`` and the rows in place.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops


class SlotManager:
    """Batch-row allocator.  The free list is a min-heap, so ``alloc``
    keeps the deterministic lowest-id-first order."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free = list(range(n_slots))  # already heap-ordered
        self.owner: dict[int, object] = {}

    def alloc(self, owner=None) -> Optional[int]:
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self.owner[slot] = owner
        return slot

    def free(self, slot: int) -> None:
        # a double free would hand one slot to two requests
        assert slot in self.owner, f"double free of slot {slot}"
        del self.owner[slot]
        heapq.heappush(self._free, slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def active_slots(self) -> list[int]:
        return sorted(self.owner)


class PageAllocator:
    """Free-list allocator over a pool of `n_pages` fixed-size pages."""

    def __init__(self, n_pages: int, page_size: int):
        assert n_pages > 0 and page_size > 0
        self.n_pages = n_pages
        self.page_size = page_size
        self._free = list(range(n_pages))
        self._owner: dict[int, object] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int, owner=None) -> Optional[list[int]]:
        """Allocate `n` pages atomically; None if the pool can't."""
        if n < 0 or n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def free(self, pages) -> None:
        for p in pages:
            assert p in self._owner, f"double free of page {p}"
            del self._owner[p]
            self._free.append(p)


class PagedKVManager:
    """Per-slot page tables over a shared :class:`PageAllocator`.

    The table is a dense ``(n_slots, max_pages)`` int32 array with -1
    for unallocated entries — the operand the paged attention paths
    consume.  ``device_table()`` keeps a copy on ``device`` (CUDA
    unless the caller names another: :func:`repro_torch.resolve_device`)
    and uploads it again only after allocation changed.
    """

    def __init__(self, n_slots: int, max_len: int, page_size: int,
                 n_pages: Optional[int] = None, *, device=None):
        self.page_size = page_size
        self.max_pages = -(-max_len // page_size)
        self.n_slots = n_slots
        if n_pages is None:
            n_pages = n_slots * self.max_pages
        self.alloc = PageAllocator(n_pages, page_size)
        self.table = np.full((n_slots, self.max_pages), -1, np.int32)
        self._n_pages_of = np.zeros(n_slots, np.int32)
        self.device = resolve_device(device)
        self.dirty = True
        self._table_dev: Optional[torch.Tensor] = None

    @property
    def n_pages(self) -> int:
        return self.alloc.n_pages

    @property
    def n_free_pages(self) -> int:
        return self.alloc.n_free

    def pages_of(self, slot: int) -> list[int]:
        return [int(p) for p in
                self.table[slot, : int(self._n_pages_of[slot])]]

    def n_pages_held(self, slot: int) -> int:
        return int(self._n_pages_of[slot])

    def device_table(self) -> torch.Tensor:
        """The page table as an int32 tensor on the device, re-uploaded
        only when ``ensure``/``release`` changed it."""
        if self._table_dev is None or self.dirty:
            self._table_dev = torch.as_tensor(self.table, device=self.device)
            self.dirty = False
        return self._table_dev

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow slot's table to cover `n_tokens`; False if out of pages
        (the slot's existing pages are untouched on failure)."""
        need = -(-n_tokens // self.page_size)
        if need > self.max_pages:
            return False
        have = int(self._n_pages_of[slot])
        if need <= have:
            return True
        got = self.alloc.alloc(need - have, owner=slot)
        if got is None:
            return False
        self.table[slot, have:need] = got
        self._n_pages_of[slot] = need
        self.dirty = True
        return True

    def release(self, slot: int) -> None:
        n = int(self._n_pages_of[slot])
        if n:
            self.alloc.free([int(p) for p in self.table[slot, :n]])
            self.dirty = True
        self.table[slot, :] = -1
        self._n_pages_of[slot] = 0


# ---------------------------------------------------------------------------
# P/D hand-off: materialize / install one sequence's KV state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVPayload:
    """One request's cache contents + generation state, materialized
    for a device-to-device hand-off (paper §6).

    ``kv`` mirrors the engine's cache tree with each page pool
    linearized to token-major ``(L, H, n_tokens, D)`` — page-layout-free,
    so the destination may use a different page size — and each
    per-slot leaf (Mamba-2 state) as the slot's bare row.
    """

    rid: int
    n_tokens: int        # cached tokens (absolute position of the next)
    last_token: int      # feeds the first decode step on the destination
    prefill_progress: int
    kv: list             # per-segment dicts of tensors (see above)

    @property
    def nbytes(self) -> int:
        """Actual payload size — what a transfer should be costed at."""
        return int(sum(t.numel() * t.element_size()
                       for seg in self.kv for t in seg.values()))


def _map_leaves(fn, caches, axes, *rest):
    """Apply ``fn(leaf, axis, *parts)`` over the cache tree (a list of
    per-segment dicts)."""
    return [{k: fn(seg[k], ax[k], *(r[i][k] for r in rest)) for k in seg}
            for i, (seg, ax) in enumerate(zip(caches, axes))]


def insert_rows(caches, new, axes, slots):
    """Copy row i of ``new`` into row ``slots[i]`` of ``caches``, in
    place, leaf by leaf (one ``index_copy_`` per leaf).

    caches/new: same-structure trees (lists of per-layer or per-segment
    dicts), ``new`` holding ``len(slots)`` rows; axes: the batch axis of
    each leaf.  Returns ``caches``.
    """
    device = next(iter(caches[0].values())).device
    dst = torch.as_tensor(slots, dtype=torch.long, device=device)

    def put(full, ax, part):
        full.index_copy_(ax, dst, part.to(full.dtype))
        return full

    return _map_leaves(put, caches, axes, new)


def clear_rows(caches, axes, slots):
    """Wipe the given slots in place: K/V rows to zero, int32 position
    rows to -1.  Leaves whose axis is None (page pools: reclaimed by the
    PageAllocator, never by row) pass through untouched."""
    def wipe(full, ax):
        if ax is None or not slots:
            return full
        idx = torch.as_tensor(slots, dtype=torch.long, device=full.device)
        full.index_fill_(ax, idx, -1 if full.dtype == torch.int32 else 0)
        return full

    return _map_leaves(wipe, caches, axes)


def gather_slot_kv(caches, axes, slot: int, page_ids: torch.Tensor,
                   n_tokens: int):
    """Materialize one sequence's cache: every page pool (axis None) is
    gathered contiguous through ``page_ids`` — one page-gather launch
    per pool, covering all layers — and sliced to ``n_tokens``; every
    per-slot leaf gives a copy of row ``slot`` on its batch axis."""
    def take(leaf, ax):
        if ax is not None:
            return leaf.select(ax, slot).clone()
        return ops.page_gather(leaf, page_ids)[:, :, :n_tokens]

    return _map_leaves(take, caches, axes)


def scatter_slot_kv(caches, axes, slot: int, page_ids: torch.Tensor,
                    payload_kv):
    """Inverse of :func:`gather_slot_kv` on the destination engine, in
    place: each contiguous (L, H, T, D) leaf is padded to the
    destination's page multiple and copied into the pool's ``page_ids``
    (the destination allocator's choice); each per-slot row lands in row
    ``slot``."""
    ids = page_ids.long()

    def put(leaf, ax, seq):
        if ax is not None:
            leaf.select(ax, slot).copy_(seq)
            return leaf
        n_l, _, h, ps, d = leaf.shape
        m = ids.shape[0]
        t = seq.shape[2]
        if m * ps < t:
            raise ValueError(f"{m} pages of {ps} cannot hold {t} tokens")
        padded = seq.new_zeros((n_l, h, m * ps, d))
        padded[:, :, :t] = seq
        chunks = padded.reshape(n_l, h, m, ps, d).transpose(1, 2)
        leaf.index_copy_(1, ids, chunks.to(leaf.dtype))
        return leaf

    return _map_leaves(put, caches, axes, payload_kv)
