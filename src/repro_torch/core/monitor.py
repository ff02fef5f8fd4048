"""Monitor subsystem (paper §4): periodic telemetry snapshots.

The dispatcher/migrator/scaler never read live worker state directly —
they read the last snapshot, refreshed every `interval` seconds (the
knob ablated in Fig. 8).  Between snapshots the dispatcher layers its
own *shadow* updates (requests it just dispatched) on top.

A copy of ``repro/core/monitor.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class WorkerSnapshot:
    wid: int
    role: str
    time: float
    busy: bool
    n_waiting: int            # requests waiting for prefill
    n_running: int            # requests in the decode batch
    kv_tokens: int            # tokens resident in KV cache
    cur_lens: tuple           # current lengths of the decode batch
    waiting_tokens: int       # prompt tokens awaiting prefill
    utilization: float        # busy fraction over the last interval


class Monitor:
    def __init__(self, interval: float = 0.05):
        self.interval = interval
        self.snapshots: dict[int, WorkerSnapshot] = {}
        self.history: list[tuple[float, float]] = []  # (time, mean util)
        self._last_busy: dict[int, float] = {}
        self._last_time: Optional[float] = None
        # arrival / completion rates over the last interval
        self.rate_in = 0.0
        self.rate_done = 0.0
        self._arrivals = 0
        self._completions = 0

    def note_arrival(self) -> None:
        self._arrivals += 1

    def note_completion(self) -> None:
        self._completions += 1

    def update(self, now: float, workers) -> None:
        """Refresh snapshots.  Workers are Backends (sim or engine);
        each one renders its own WorkerSnapshot, so the Monitor never
        reaches into plane-specific state."""
        dt = (now - self._last_time) if self._last_time is not None else None
        utils = []
        for w in workers:
            if dt and dt > 0:
                busy_delta = w.busy_time - self._last_busy.get(w.wid, 0.0)
                util = min(1.0, busy_delta / dt)
            else:
                util = 1.0 if w.is_busy(now) else 0.0
            self._last_busy[w.wid] = w.busy_time
            utils.append(util)
            self.snapshots[w.wid] = w.snapshot(now, util)
        if dt and dt > 0:
            self.rate_in = self._arrivals / dt
            self.rate_done = self._completions / dt
            self._arrivals = 0
            self._completions = 0
            if utils:
                self.history.append((now, sum(utils) / len(utils)))
        self._last_time = now

    def snapshot(self, wid: int) -> Optional[WorkerSnapshot]:
        return self.snapshots.get(wid)

    def mean_utilization(self) -> float:
        if not self.snapshots:
            return 0.0
        vals = [s.utilization for s in self.snapshots.values()]
        return sum(vals) / len(vals)
