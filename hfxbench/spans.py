"""Readings of the program's own spans (``repro_torch.serving.tracing``)
in a traced run.

The harness turns the program's recorder on for a traced run's window
(:func:`recording`) and leaves it off otherwise, so that a run judged
end to end executes none of it.  A traced run then holds:

- ``run.spans``: the recorder's spans, drained after the loop, with
  ``start`` and ``end`` in seconds from the window's opening (as a
  ``Step``'s ``t0``): :func:`window_spans`.  Engine spans nest
  ``engine.step`` over ``engine.schedule``, ``engine.dispatch``,
  ``engine.sync`` and ``engine.commit``; a ``request.queue`` span
  carries its request id.
- ``Step.dispatch``: the attributes of each step's ``engine.dispatch``
  span (``{}`` for a step that dispatched nothing), the step's counters;
  ``Step.parts``: the seconds of its ``engine.step`` span and of each of
  its parts (:func:`attach`).  Where the spans and the steps do not pair
  one to one, both stay None on every step.
- ``run.trace["idle_by_span"]``: the profiled sub-window's idle seconds,
  on the trace's own clock, by the engine span whose ``user_annotation``
  event holds each idle interval's middle, ``none`` where no engine span
  does; they add up to the sub-window's idle time, ``window_s`` less
  ``busy_s`` (:func:`hfxbench.trace.summarize`).

A reader returns None where its input is missing: an untraced run, a
program without the recorder, a CPU trace.  As the other readers, step
readings take the steps (``Run.window_steps``) and request spans that
began in the window before the sub-window, device readings the
sub-window alone; shares are in percent.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from hfxbench.trace import ENGINE, OUTSIDE


@contextlib.contextmanager
def recording(on: bool):
    """The program's span recorder on inside the block where ``on``;
    yields the list that holds what it recorded once the block ends (None
    where not ``on``).  The recorder is off after the block, also when
    the block raises."""
    if not on:
        yield None
        return
    from repro_torch.serving import tracing

    tracing.drain()        # nothing recorded before the block
    tracing.enable()
    out: list = []
    try:
        yield out
    finally:
        out.extend(tracing.drain())
        tracing.disable()


def window_spans(spans: list, base: float) -> list:
    """The recorder's spans with times in seconds from ``base`` (the
    window's opening on ``time.perf_counter``)."""
    return [s._replace(start=s.start - base, end=s.end - base)
            for s in spans]


def attach(steps: list, spans: list) -> Optional[str]:
    """Give each step the attributes of its ``engine.dispatch`` span
    (``{}`` where it dispatched nothing), and the seconds of its
    ``engine.step`` span and of each of its parts: the ``engine.step``
    spans pair with the steps one to one, in order, each of the step's
    kind.  Where they do not, no step gets either, and the reason is
    returned."""
    roots = [s for s in spans if s.name == "engine.step"]
    if len(roots) != len(steps):
        return (f"{len(roots)} engine.step spans against {len(steps)} "
                f"steps")
    for i, (span, step) in enumerate(zip(roots, steps)):
        if span.attrs.get("kind") != step.kind:
            return (f"step {i} is {step.kind!r} but its span is "
                    f"{span.attrs.get('kind')!r}")
    parts: dict = {}
    for s in spans:
        if s.parent is not None and s.name.startswith(ENGINE):
            parts.setdefault(s.parent, {})[s.name] = s
    for span, step in zip(roots, steps):
        mine = parts.get(span.sid, {})
        step.dispatch = (dict(mine["engine.dispatch"].attrs)
                         if "engine.dispatch" in mine else {})
        step.parts = {n: p.end - p.start for n, p in mine.items()}
        step.parts[span.name] = span.end - span.start
    return None


def _counted(run, kind: Optional[str] = None):
    """The window's steps (of ``kind``) where every one carries its
    spans' readings, else None."""
    steps = run.window_steps(kind)
    if not steps or any(s.dispatch is None for s in steps):
        return None
    return steps


def queue_wait_ms(run):
    """The mean, over the requests due in the window, of the time each
    spent in the engine's queue (its ``request.queue`` spans that began
    before the sub-window, summed: a preempted request queues again).  A
    mean, not a tail: most requests are admitted at the next step, so a
    high percentile falls on the edge between that and a wait of one
    decode pass."""
    if run.spans is None:
        return None
    due = {r.rid for r in run.due_in_window()}
    waits: dict = {}
    for s in run.spans:
        if (s.name == "request.queue" and s.rid in due
                and 0.0 <= s.start < run.span_s):
            waits[s.rid] = waits.get(s.rid, 0.0) + s.end - s.start
    return 1e3 * sum(waits.values()) / len(waits) if waits else None


def _prefill_dispatches(run):
    steps = _counted(run, "prefill_chunk")
    return None if steps is None else [s.dispatch for s in steps
                                       if s.dispatch]


def prefill_lane_use(run):
    """Real prompt tokens over the lanes the prefill chunks computed."""
    ds = _prefill_dispatches(run)
    lanes = sum(d["lanes"] for d in ds) if ds else 0
    return 100.0 * sum(d["tokens"] for d in ds) / lanes if lanes else None


def prefill_pair_use(run):
    """(query, key) pairs the prefill chunks' real tokens need under the
    causal mask, over those their chunk attention scored."""
    ds = _prefill_dispatches(run)
    pairs = sum(d.get("pairs", 0) for d in ds) if ds else 0
    return (100.0 * sum(d["pairs_needed"] for d in ds) / pairs
            if pairs else None)


def decode_graph_share(run):
    """Decode iterations that replayed the engine's captured decode
    iteration (their step's dispatch has ``graph`` 1), over all the
    decode steps' iterations."""
    steps = _counted(run, "decode")
    if steps is None:
        return None
    iters = sum(s.k for s in steps)
    return (100.0 * sum(s.k for s in steps if s.dispatch.get("graph") == 1)
            / iters if iters else None)


def decode_enqueue_ms(run):
    """The decode steps' summed ``engine.dispatch`` (the host enqueueing
    every launch of the pass) over their iterations."""
    steps = _counted(run, "decode")
    if steps is None:
        return None
    iters = sum(s.k for s in steps)
    spent = sum(s.parts.get("engine.dispatch", 0.0) for s in steps)
    return 1e3 * spent / iters if iters else None


def host_ms_per_step(run):
    """Mean time of a step outside its dispatch and its wait for the
    device: scheduling, and the commit of what it returned."""
    steps = _counted(run)
    if steps is None:
        return None
    own = [s.parts["engine.step"] - s.parts.get("engine.dispatch", 0.0)
           - s.parts.get("engine.sync", 0.0) for s in steps]
    return 1e3 * sum(own) / len(own)


def _idle(run, name: str):
    trace = run.trace
    if (trace is None or "idle_by_span" not in trace
            or trace["busy_s"] <= 0):
        return None
    return 100.0 * trace["idle_by_span"].get(name, 0.0) / trace["window_s"]


def idle_in_dispatch(run):
    """Share (%) of the sub-window the card stood idle while the host
    was inside ``engine.dispatch``."""
    return _idle(run, "engine.dispatch")


def idle_outside_engine(run):
    """Share (%) of the sub-window the card stood idle outside every
    engine span."""
    return _idle(run, OUTSIDE)
