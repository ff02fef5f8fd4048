"""Priority-based SLO mapping (paper §5.2, Algorithm 2, Eq. 6).

Derives absolute (TTFT, TPOT) targets for a request that only carries a
relative priority p in [0, N-1] (0 = highest):

1. sliding windows of the W most recent measured TTFT/TPOT values,
   kept value-sorted (so indexing = quantile selection);
2. index i_s = base + offset with base = sum_{i<p} C_i and
   offset = floor((p+1)/(N+1) * C_p) — higher priorities land on lower
   latency quantiles (Eq. 6);
3. queue-time-spike correction: subtract the extra queuing delay between
   the reference request and the last same-priority request;
4. clamp into the per-priority [min, max] band;
5. contention rule: while higher-priority requests are pending, lower
   priorities are pushed to their relaxed bound so strict ordering is
   preserved (this is what makes Fig. 6 work).

A copy of ``repro/core/slo_mapper.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class PriorityBand:
    min_ttft: float
    max_ttft: float
    min_tpot: float
    max_tpot: float


@dataclasses.dataclass
class _Record:
    value: float
    queue_time: float
    priority: int
    seq: int


class PrioritySLOMapper:
    def __init__(self, bands: Sequence[PriorityBand], window: int = 200):
        self.n = len(bands)
        self.bands = list(bands)
        self.window = window
        # value-sorted windows + FIFO for eviction
        self._ttft_sorted: list[tuple[float, float]] = []  # (ttft, q_time)
        self._tpot_sorted: list[float] = []
        self._fifo: collections.deque = collections.deque()
        self._counts = [0] * self.n
        self._last_queue_time = [0.0] * self.n
        self._seq = 0

    # -- observation of completed requests -----------------------------------
    def observe(self, priority: int, ttft: float, tpot: float,
                queue_time: float) -> None:
        self._seq += 1
        rec = _Record(ttft, queue_time, priority, self._seq)
        self._fifo.append((rec, tpot))
        bisect.insort(self._ttft_sorted, (ttft, queue_time))
        bisect.insort(self._tpot_sorted, tpot)
        self._counts[priority] += 1
        if len(self._fifo) > self.window:
            old, old_tpot = self._fifo.popleft()
            i = bisect.bisect_left(
                self._ttft_sorted, (old.value, old.queue_time)
            )
            if i < len(self._ttft_sorted):
                self._ttft_sorted.pop(i)
            j = bisect.bisect_left(self._tpot_sorted, old_tpot)
            if j < len(self._tpot_sorted):
                self._tpot_sorted.pop(j)
            self._counts[old.priority] -= 1

    # -- Eq. 6 indexing -------------------------------------------------------
    def _index(self, p: int) -> int:
        base = sum(self._counts[:p])
        offset = int((p + 1) / (self.n + 1) * self._counts[p])
        return base + offset

    # -- Algorithm 2 ----------------------------------------------------------
    def assign(self, priority: int, *,
               higher_priority_pending: bool = False) -> tuple[float, float]:
        band = self.bands[priority]
        if higher_priority_pending:
            # contention: strict prioritization — relax lower priorities
            # to their loosest bound to preserve capacity upstream.
            return band.max_ttft, band.max_tpot
        if not self._ttft_sorted:
            mid = lambda lo, hi: 0.5 * (lo + hi)  # noqa: E731
            return (mid(band.min_ttft, band.max_ttft),
                    mid(band.min_tpot, band.max_tpot))
        idx = min(self._index(priority), len(self._ttft_sorted) - 1)
        ttft, q_time = self._ttft_sorted[idx]
        tpot = self._tpot_sorted[min(idx, len(self._tpot_sorted) - 1)]
        # queue-time-spike correction
        dq = q_time - self._last_queue_time[priority]
        ttft = ttft - dq
        self._last_queue_time[priority] = q_time
        ttft = min(max(ttft, band.min_ttft), band.max_ttft)
        tpot = min(max(tpot, band.min_tpot), band.max_tpot)
        return ttft, tpot


def bands_from_tasks(specs, spread: float = 0.25) -> list[PriorityBand]:
    """Paper §7.3: median SLO targets +-25% per priority level."""
    out = []
    for s in sorted(specs, key=lambda t: t.priority):
        out.append(PriorityBand(
            min_ttft=s.ttft_slo * (1 - spread),
            max_ttft=s.ttft_slo * (1 + spread),
            min_tpot=s.tpot_slo * (1 - spread),
            max_tpot=s.tpot_slo * (1 + spread),
        ))
    return out
