"""The device trace of a traced run's steady sub-window.

``torch.profiler`` (CUPTI) records a fixed number of engine steps, so
that the trace stays small; it is written as a chrome trace to a
temporary file, read back and deleted.  The reading is that of
``chip_smoke.py``'s ``trace_summary``, copied: busy time is the union of
the device's operation intervals (kernels, and here also the device's
copies and fills), kernel time is summed by name.  The sub-window is
read on the trace's own clock: a ``record_function`` range (``MARK``)
opens after the profiler starts and closes after the last step's sync,
and idle time is taken inside it, widened where the trace stamps a
device operation beyond it.  Each idle interval (between device
operations, and from the window's edges to the first and last of them)
is put down to the host call that was running at its middle: the
innermost CPU op or CUDA runtime call whose interval holds it, or
``python`` where none does; and again to the program's innermost engine
span (``repro_torch.serving.tracing``, a ``user_annotation`` event) that
holds it, or ``none`` where none does."""

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
ENGINE = "engine."   # the program's engine spans
OUTSIDE = "none"     # idle under no engine span: the harness's loop
MARK = "hfxbench.sub_window"   # the sub-window as the trace records it


class SubWindow:
    """Profiles ``steps`` engine steps from the first step boundary at
    or after ``start_s`` (seconds from the window's opening).  Ending
    the recording takes seconds of host time, which stall the loop:
    metrics of the traced run read only the window before the sub-window
    (steps) and the sub-window itself (the device)."""

    def __init__(self, start_s: float, steps: int, cuda: bool):
        self.start_s, self.steps, self.cuda = start_s, steps, cuda
        self.prof = None      # recording
        self.mark = None      # the sub-window's record_function range
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

    @staticmethod
    def _mark():
        from torch.profiler import record_function

        rf = record_function(MARK)
        rf.__enter__()
        return rf

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
            self.mark = self._mark()
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
        self.mark.__exit__(None, None, None)
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


def _window(events: list[dict]) -> tuple[float, float] | None:
    """The sub-window on the trace's clock (us): its marker's interval."""
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e.get("name") == MARK):
            return e["ts"], e["ts"] + e["dur"]
    return None


def _gaps(busy: list[tuple[float, float]], lo: float,
          hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] in which no device operation ran."""
    out, a = [], lo
    for b0, b1 in busy:
        if b0 > a:
            out.append((a, b0))
        a = max(a, b1)
    if hi > a:
        out.append((a, hi))
    return out


def _by_holder(gaps: list[tuple[float, float]],
               holders: list[tuple[float, float, str]], none: str) -> dict:
    """Idle seconds of ``gaps``, by the innermost holder (the
    latest-starting one) whose interval holds each gap's middle, or
    ``none``."""
    out: dict[str, float] = defaultdict(float)
    mids = sorted(((a + b) / 2, (b - a) / 1e6) for a, b in gaps)
    holders = sorted(holders)
    heap: list = []
    i = 0
    for mid, length in mids:
        while i < len(holders) and holders[i][0] <= mid:
            heapq.heappush(heap, (-holders[i][0], holders[i][1],
                                  holders[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else none] += length
    return dict(out)


def _held(events: list[dict], cats: tuple, prefix: str = "") -> list:
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in cats and e.get("ph") == "X"
            and e["name"].startswith(prefix)]


def _early(events: list[dict], ops: list[dict]) -> float:
    """How far (us) the trace stamps a device operation before the CUDA
    runtime call that launched it (their ``correlation``): a lower bound
    on how far its device stamps stray from its host stamps."""
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    return max([0.0] + [launch[c] - e["ts"] for e in ops
                        if (c := e.get("args", {}).get("correlation"))
                        in launch])


def summarize(events: list[dict], wall_s: float) -> dict:
    """Busy seconds, device operations by name (seconds, count), and
    idle seconds by what the host was doing and by engine span, all on
    the trace's clock.  The window is the sub-window's marker, widened
    to hold every device operation (they all ran inside it: it opens and
    closes on a synchronized device), or in a trace without the marker
    the operations' own extent: ``window_s`` is its length, and each
    idle split adds up to ``window_s`` less ``busy_s``.  ``wall_s`` is
    the sub-window on the host's clock; ``outside_s``, the device time
    stamped outside the marker, and ``early_s``, how far a device
    operation is stamped before its launch, read how far the trace's
    device stamps stray from its host stamps, which the split by holder
    cannot correct."""
    ops = [e for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    busy_spans = _union([(e["ts"], e["ts"] + e["dur"]) for e in ops])
    win = _window(events)
    edges = ([win] if win else []) + busy_spans[:1] + busy_spans[-1:]
    lo = min((a for a, _ in edges), default=0.0)
    hi = max((b for _, b in edges), default=0.0)
    by_name: dict[str, list] = {}
    for e in ops:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"] / 1e6
        row[1] += 1
    gaps = _gaps(busy_spans, lo, hi)
    return {"busy_s": sum(b - a for a, b in busy_spans) / 1e6,
            "window_s": (hi - lo) / 1e6, "wall_s": wall_s,
            "outside_s": (sum(max(0.0, min(b, win[0]) - a)
                              + max(0.0, b - max(a, win[1]))
                              for a, b in busy_spans) / 1e6
                          if win else 0.0),
            "early_s": _early(events, ops) / 1e6,
            "kernels": {k: {"s": v[0], "n": v[1]}
                        for k, v in by_name.items()},
            "idle_by_host": _by_holder(gaps, _held(events, HOST_CATS),
                                       "python"),
            "idle_by_span": _by_holder(
                gaps, _held(events, ("user_annotation",), ENGINE),
                OUTSIDE)}


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host
    calls under which the device stood idle longest, in seconds."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["s"])
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:200], v["s"]] for k, v in ops[:10]],
            "idle_gaps": [[k[:200], v] for k, v in gaps[:10]]}
