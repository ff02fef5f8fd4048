"""Spans of the engine's own steps and of its requests, on the host's
clock (``time.perf_counter``).

One process-wide recorder, off by default.  An operator turns it on
around the part of a run to be read, and drains it after::

    from repro_torch.serving import tracing

    tracing.enable()
    ...                          # engine.submit(...), engine.step(), ...
    spans = tracing.drain()      # the closed spans, in the order they
    tracing.disable()            # closed; the recorder keeps none of them

Each :class:`Span` holds its name, its start and end in seconds of
``time.perf_counter()``, its own id and its parent's, the engine it came
from (``InferenceEngine.trace_id``), the request id where it has one, and
a few integer attributes (``kind`` is a string).

Engine spans, one tree per ``InferenceEngine.step()`` call:

- ``engine.step`` — the whole call; ``kind`` (the step's event kind)
  and ``k`` (decode iterations; 1 otherwise).
  - ``engine.schedule`` — step entry to the stamp the Eq. 5 profiler's
    ``dt`` starts from: admission into slots, the Eq. 5 budget, page
    reservation, the choice of K, preemption, drafting.
  - ``engine.dispatch`` — from that stamp until the model call returns:
    the host's enqueue of every launch, the uploads in its arguments
    included.  ``lanes``: the rows × positions computed (× K for a fused
    block); ``tokens``: the real tokens prefilled or emitted; ``graph``:
    1 where the dispatch replayed the engine's captured decode
    iteration (one graph launch an iteration), else 0.  A paged
    prefill chunk adds ``pairs`` (lanes × key positions its chunk
    attention scores) and ``pairs_needed`` (the causal pairs its real
    tokens need).
  - ``engine.sync`` — the wait for the device, up to the stamp ``dt``
    ends at.
  - ``engine.commit`` — readback, token bookkeeping, retirement and the
    profiler's ``observe_*``.
- ``engine.fit_profiler`` — a root span around ``fit_profiler()``.

One request span, ``request.queue``, with the request id: from
``submit()`` (or a recompute preemption) to the request's slot
allocation; its parent is the engine step that admitted it.  Both moves
made inside a step are stamped at the step's entry, when it schedules
them.  A request that leaves the queue otherwise (a cluster withdrawing
it) records no span.

While a ``torch.profiler`` session records, each engine span also enters
``torch.profiler.record_function`` under its name, so the device trace
holds it as a ``user_annotation`` event on the profiler's own clock:
the trace's idle gaps can be put down to the engine's steps.  Request
spans never enter it: they outlive steps, and would claim idle time
that belongs to the client.

With the recorder off, a step costs one flag test and records nothing.
On, the recorder stamps step entry, the model call's return and step
exit, and builds its spans after the stamps the engine's ``dt`` is
taken from: only the return's stamp falls inside ``dt``, and under a
recording profiler the switch from one ``record_function`` range to the
next as well.
"""

from __future__ import annotations

import itertools
import time
from types import MappingProxyType
from typing import Mapping, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start: float
    end: float
    sid: int
    parent: Optional[int]
    engine: int
    rid: Optional[int]
    attrs: Mapping


NO_ATTRS = MappingProxyType({})   # a span without attributes


class Recorder:
    """Closed spans in memory, and the queue entry time of each request
    in an engine's queue."""

    def __init__(self):
        self.on = False
        self.spans: list[Span] = []
        self._queued: dict[tuple[int, int], float] = {}
        self.ids = itertools.count()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False
        self._queued.clear()

    def drain(self) -> list[Span]:
        out, self.spans = self.spans, []
        return out

    def queue(self, engine: int, rid: int, opens: bool,
              step: Optional["StepTrace"] = None) -> None:
        """Request ``rid`` enters (``opens``) or leaves ``engine``'s
        queue, at ``step``'s entry, or now outside a step."""
        t = now() if step is None else step.start
        if opens:
            self._queued[(engine, rid)] = t
            return
        start = self._queued.pop((engine, rid), None)
        if start is not None:
            self.spans.append(Span(
                "request.queue", start, t, next(self.ids),
                None if step is None else step.sid, engine, rid, NO_ATTRS))


class StepTrace:
    """The spans of one engine step (or another root span, without
    ``parts``), recorded when it ends: the step, and its parts cut at
    the dispatch's stamps."""

    def __init__(self, rec: Recorder, engine: int, name: str = "engine.step",
                 parts: bool = True):
        self.rec, self.engine, self.name, self.parts = rec, engine, name, parts
        self.sid = next(rec.ids)
        self.start = now()
        self.stamps: Optional[tuple] = None   # (t0, return, t1, attrs)
        # the profiler's record_function ranges, innermost last
        self.notes = ([] if torch.autograd.profiler._is_profiler_enabled
                      else None)
        if self.notes is not None:
            self._enter(name)
            if parts:
                self._enter("engine.schedule")

    def _enter(self, name: str) -> None:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self.notes.append(rf)

    def switch(self, part: str) -> None:
        """Under a recording profiler: leave the open part's range and
        enter ``part``'s."""
        self.notes.pop().__exit__(None, None, None)
        self._enter(part)

    def dispatched(self, t0: float, back: float, t1: float,
                   attrs: dict) -> None:
        """The step's dispatch: the model call from ``t0`` to its return
        ``back``, the device's work done at ``t1``."""
        self.stamps = (t0, back, t1, attrs)

    def end(self, ev: Optional[dict]) -> None:
        """Close every span of the step; ``ev`` is what the step
        returned (None when it raised)."""
        t = now()
        while self.notes:
            self.notes.pop().__exit__(None, None, None)
        ev = ev or {}
        cuts = []
        if self.parts and self.stamps is None:
            cuts = [("engine.schedule", self.start, t, NO_ATTRS)]
        elif self.parts:
            t0, back, t1, attrs = self.stamps
            if "tokens" in ev:
                attrs["tokens"] = int(ev["tokens"])
            cuts = [("engine.schedule", self.start, t0, NO_ATTRS),
                    ("engine.dispatch", t0, back, attrs),
                    ("engine.sync", back, t1, NO_ATTRS),
                    ("engine.commit", t1, t, NO_ATTRS)]
        ids, spans = self.rec.ids, self.rec.spans
        for name, a, b, attrs in cuts:
            spans.append(Span(name, a, b, next(ids), self.sid, self.engine,
                              None, attrs))
        attrs = NO_ATTRS
        if self.name == "engine.step":
            attrs = {"kind": ev.get("kind", "error"),
                     "k": int(ev.get("k", 1))}
        spans.append(Span(self.name, self.start, t, self.sid, None,
                          self.engine, None, attrs))


now = time.perf_counter     # the recorder's own stamps
RECORDER = Recorder()
enable = RECORDER.enable
disable = RECORDER.disable
drain = RECORDER.drain
_engine_ids = itertools.count()


def new_engine_id() -> int:
    return next(_engine_ids)


def begin(engine: int, name: str = "engine.step",
          parts: bool = True) -> Optional[StepTrace]:
    """The trace of a step (or of another root span, ``parts`` False)
    starting now; None while the recorder is off."""
    if not RECORDER.on:
        return None
    return StepTrace(RECORDER, engine, name, parts)
