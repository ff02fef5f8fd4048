"""Priority queues of Algorithm 1.

- RequestPriorityQueue (Q_R): requests ordered by (TPOT SLO, arrival).
- WorkerPriorityQueue (Q_W): workers ordered by maturity time.

A copy of ``repro/core/queues.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Iterator, Optional

from repro_torch.core.request import Request


class RequestPriorityQueue:
    """Sorted by (tpot_slo, arrival); supports scan + selective removal."""

    def __init__(self):
        self._heap: list[tuple[float, float, int, Request]] = []
        self._removed: set[int] = set()
        self._count = itertools.count()

    def add(self, r: Request) -> None:
        if r.rid in self._removed:
            # re-admission (e.g. a migration destination vanished and
            # the request was requeued): clear the tombstone, and purge
            # stale heap entries so the rid can't be yielded twice
            self._removed.discard(r.rid)
            self._heap = [e for e in self._heap if e[3].rid != r.rid]
            heapq.heapify(self._heap)
        heapq.heappush(
            self._heap, (r.tpot_slo, r.arrival, next(self._count), r)
        )

    def __len__(self) -> int:
        return sum(
            1 for *_k, r in self._heap if r.rid not in self._removed
        )

    def __bool__(self) -> bool:
        self._compact()
        return bool(self._heap)

    def _compact(self) -> None:
        while self._heap and self._heap[0][3].rid in self._removed:
            heapq.heappop(self._heap)

    def scan(self) -> Iterator[Request]:
        """Iterate in priority order without removing."""
        for item in sorted(self._heap):
            r = item[3]
            if r.rid not in self._removed:
                yield r

    def remove(self, r: Request) -> None:
        self._removed.add(r.rid)
        self._compact()

    def peek(self) -> Optional[Request]:
        self._compact()
        return self._heap[0][3] if self._heap else None

    def items(self) -> list[Request]:
        return list(self.scan())


class WorkerPriorityQueue:
    """Min-heap of workers keyed by maturity time."""

    def __init__(self):
        self._heap: list[tuple[float, int, object]] = []
        self._count = itertools.count()

    def push(self, worker, maturity: float) -> None:
        heapq.heappush(self._heap, (maturity, next(self._count), worker))

    def pop(self):
        if not self._heap:
            return None, None
        maturity, _, w = heapq.heappop(self._heap)
        return w, maturity

    def peek(self):
        if not self._heap:
            return None, None
        maturity, _, w = self._heap[0]
        return w, maturity

    def __len__(self) -> int:
        return len(self._heap)

    def clear(self) -> None:
        self._heap.clear()
