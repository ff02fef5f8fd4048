"""The device trace of a traced run's steady sub-window.

``torch.profiler`` (CUPTI) records a fixed number of engine steps, so
that the trace stays small; it is written as a chrome trace to a
temporary file, read back and deleted.  The reading is that of
``chip_smoke.py``'s ``trace_summary``, copied: busy time is the union of
the device's operation intervals (kernels, and here also the device's
copies and fills), kernel time is summed by name.  Each idle gap
between device operations is put down to the host call that was
running at its middle: the innermost CPU op or CUDA runtime call whose
interval holds it, or ``python`` where none does.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
import warnings
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")


class SubWindow:
    """Profiles ``steps`` engine steps from the first step boundary at
    or after ``start_s`` (seconds from the window's opening).  Ending
    the recording takes seconds of host time, which stall the loop:
    metrics of the traced run read only the window before the sub-window
    (steps) and the sub-window itself (the device)."""

    def __init__(self, start_s: float, steps: int, cuda: bool):
        self.start_s, self.steps, self.cuda = start_s, steps, cuda
        self.prof = None      # recording
        self.done = None      # recorded
        self.taken = 0
        self.wall = None      # (start, stop) on the host's clock
        self.opened_at = None  # seconds from the window's opening
        self.stop_cost_s = 0.0

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self, fn) -> None:
        """Start and stop the profiler once around ``fn`` during set-up,
        so that its first start (CUPTI's) costs nothing in the window."""
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Warning: Profiler clears")
            with self._profile():
                fn()

    def active(self) -> bool:
        return self.prof is not None

    def before_step(self, now: float, sync) -> None:
        if self.prof is None and self.wall is None and now >= self.start_s:
            sync()
            self.prof = self._profile()
            self.prof.__enter__()
            self.wall = [time.perf_counter(), None]
            self.opened_at = now

    def after_step(self, sync) -> None:
        if self.prof is None:
            return
        self.taken += 1
        if self.taken >= self.steps:
            self.stop(sync)

    def stop(self, sync) -> None:
        """End the recording; the trace is written and read after the
        loop (``summary``), where it delays no request."""
        if self.prof is None:
            return
        sync()
        self.wall[1] = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_cost_s = time.perf_counter() - self.wall[1]
        self.done, self.prof = self.prof, None

    def summary(self) -> dict | None:
        if self.done is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.done.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events, self.wall[1] - self.wall[0])


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _idle_by_host(busy: list[tuple[float, float]],
                  host: list[tuple[float, float, str]]) -> dict:
    """Idle seconds between the busy spans, by the innermost host call
    (the latest-starting one) whose interval holds each gap's middle."""
    out: dict[str, float] = defaultdict(float)
    gaps = sorted(((a + b) / 2, (b - a) / 1e6)
                  for (_, a), (b, _) in zip(busy, busy[1:]) if b > a)
    host = sorted(host)
    heap: list = []
    i = 0
    for mid, length in gaps:
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "python"] += length
    return dict(out)


def summarize(events: list[dict], wall_s: float) -> dict:
    """Busy seconds, device operations by name (seconds, count), and
    idle seconds by what the host was doing."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    busy_spans = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(b - a for a, b in busy_spans)
    by_name: dict[str, list] = {}
    for e in dev:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"] / 1e6
        row[1] += 1
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e.get("ph") == "X"]
    return {"busy_s": busy / 1e6, "window_s": wall_s,
            "kernels": {k: {"s": v[0], "n": v[1]} for k, v in by_name.items()},
            "idle_by_host": _idle_by_host(busy_spans, host)}


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host
    calls under which the device stood idle longest, in seconds."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["s"])
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:200], v["s"]] for k, v in ops[:10]],
            "idle_gaps": [[k[:200], v] for k, v in gaps[:10]]}
