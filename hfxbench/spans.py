"""Readings of the program's own spans (``repro_torch.serving.tracing``)
in a traced run.

Two inputs, both absent from a run that did not record them:

- ``run.spans``: the recorder's spans, drained after the loop, with
  ``start`` and ``end`` in seconds from the window's opening (as a
  ``Step``'s ``t0``): :func:`window_spans`.  Engine spans nest
  ``engine.step`` over ``engine.schedule``, ``engine.dispatch``,
  ``engine.sync`` and ``engine.commit``; a ``request.queue`` span
  carries its request id.
- ``run.trace["idle_by_span"]``: the profiled sub-window's idle seconds
  by the engine span whose ``user_annotation`` event holds each gap's
  middle, ``none`` where no engine span does: :func:`idle_by_span`.

The harness records neither yet: each reader returns None until it
does.  As the other readers, step readings take the spans that began in
the window before the sub-window, device readings the sub-window alone;
shares are in percent.
"""

from __future__ import annotations

from hfxbench import slo
from hfxbench.trace import DEVICE_CATS, _idle_by_host, _union

ENGINE = "engine."
OUTSIDE = "none"   # idle under no engine span: the harness's loop


def window_spans(spans: list, base: float) -> list:
    """The recorder's spans with times in seconds from ``base`` (the
    window's opening on ``time.perf_counter``)."""
    return [s._replace(start=s.start - base, end=s.end - base)
            for s in spans]


def idle_by_span(events: list[dict]) -> dict:
    """Idle seconds between the device's operations, by the innermost
    engine span (its ``user_annotation`` event) that holds each gap's
    middle, or ``none``."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    notes = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e["name"].startswith(ENGINE)]
    out = _idle_by_host(busy, notes)
    if "python" in out:    # _idle_by_host's name for "no holder"
        out[OUTSIDE] = out.pop("python")
    return out


def _spans(run):
    spans = getattr(run, "spans", None)
    return None if spans is None else [
        s for s in spans if 0.0 <= s.start < run.span_s]


def _steps(run, kind=None):
    """(step span, {part name: part span}) of the window's steps."""
    spans = _spans(run)
    if spans is None:
        return None
    parts: dict = {}
    for s in run.spans:
        if s.parent is not None and s.name.startswith(ENGINE):
            parts.setdefault(s.parent, {})[s.name] = s
    return [(s, parts.get(s.sid, {})) for s in spans
            if s.name == "engine.step"
            and (kind is None or s.attrs.get("kind") == kind)]


def queue_wait_ms(run, q: float = 80):
    """The q-th percentile, over the requests due in the window, of the
    time each spent in the engine's queue (its ``request.queue`` spans
    summed: a preempted request queues again)."""
    spans = _spans(run)
    if spans is None:
        return None
    due = {r.rid for r in run.due_in_window()}
    waits: dict = {}
    for s in spans:
        if s.name == "request.queue" and s.rid in due:
            waits[s.rid] = waits.get(s.rid, 0.0) + s.end - s.start
    return 1e3 * slo.percentile(list(waits.values()), q) if waits else None


def _prefill_dispatches(run):
    steps = _steps(run, "prefill_chunk")
    return None if steps is None else [
        p["engine.dispatch"].attrs for _, p in steps if "engine.dispatch" in p]


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


def decode_enqueue_ms(run):
    """The decode steps' summed ``engine.dispatch`` (the host enqueueing
    every launch of the pass) over their iterations."""
    steps = _steps(run, "decode")
    if not steps:
        return None
    iters = sum(s.attrs["k"] for s, _ in steps)
    spent = sum(p["engine.dispatch"].end - p["engine.dispatch"].start
                for _, p in steps if "engine.dispatch" in p)
    return 1e3 * spent / iters if iters else None


def host_ms_per_step(run):
    """Mean time of a step outside its dispatch and its wait for the
    device: scheduling, and the commit of what it returned."""
    steps = _steps(run)
    if not steps:
        return None
    own = [s.end - s.start - sum(p[n].end - p[n].start
                                 for n in ("engine.dispatch", "engine.sync")
                                 if n in p)
           for s, p in steps]
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
