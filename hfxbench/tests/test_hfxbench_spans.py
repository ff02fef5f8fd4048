"""The readings of the program's spans (``hfxbench/spans.py``): the idle
gaps of a device trace put down to engine spans, on a hand-made event
list; each reader on a hand-made run, and None on a run without spans;
``summarize`` unmoved by the spans' events."""

import numpy as np
import pytest

from hfxbench import spans as sp
from hfxbench.harness import Run
from hfxbench.tests.conftest import smoke_config
from hfxbench.trace import summarize
from hfxbench.traffic import Req
from repro_torch.serving.tracing import Span


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# device busy [0, 10], [20, 30], [50, 60], [100, 110], [130, 140] (us)
EVENTS = [
    _x("kernel", "gemm", 0, 10), _x("kernel", "gemm", 20, 10),
    _x("gpu_memcpy", "copy", 50, 10), _x("kernel", "attn", 100, 10),
    _x("kernel", "attn", 130, 10),
    # a step [2, 95] and its parts; then the harness's loop
    _x("user_annotation", "engine.step", 2, 93),
    _x("user_annotation", "engine.schedule", 2, 10),
    _x("user_annotation", "engine.dispatch", 12, 30),
    _x("user_annotation", "engine.sync", 42, 40),
    _x("user_annotation", "engine.commit", 82, 13),
    # a second step's dispatch holds the last gap
    _x("user_annotation", "engine.step", 112, 30),
    _x("user_annotation", "engine.dispatch", 114, 20),
    # not engine spans: never a holder
    _x("user_annotation", "request.queue", 0, 140),
    _x("user_annotation", "ProfilerStep#1", 0, 140),
    # host calls, read by summarize alone
    _x("cpu_op", "aten::mm", 12, 10), _x("cuda_runtime", "cudaLaunchKernel",
                                         35, 8),
]


def test_idle_by_span_nests_and_names_what_no_span_holds():
    # gaps (10, 20) mid 15: dispatch; (30, 50) mid 40: dispatch (the
    # step's innermost); (60, 100) mid 80: sync; (110, 130) mid 120:
    # the second step's dispatch
    got = sp.idle_by_span(EVENTS)
    assert got == pytest.approx({"engine.dispatch": (10 + 20 + 20) / 1e6,
                                 "engine.sync": 40 / 1e6})
    # a gap under no engine span: "none"
    late = EVENTS + [_x("kernel", "gemm", 200, 10)]
    got = sp.idle_by_span(late)
    assert got[sp.OUTSIDE] == pytest.approx(60 / 1e6)
    assert "python" not in got and "request.queue" not in got


def test_summarize_unmoved_by_span_events():
    """The spans' ``user_annotation`` events change none of summarize's
    keys: busy time, operations by name and idle time by host call."""
    plain = [e for e in EVENTS if e["cat"] != "user_annotation"]
    keys = ("busy_s", "window_s", "kernels", "idle_by_host")
    got, want = summarize(EVENTS, 140e-6), summarize(plain, 140e-6)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def _req(rid, due):
    return Req(rid, "chat", due, 10, 4, 1.0, 0.1, np.zeros(10, np.int32))


def _step(sid, t, parts, kind, k=1, **attrs):
    """A step span at ``t`` and its parts laid end to end (durations in
    ``parts``); ``attrs`` go on its dispatch."""
    out, a = [], t
    for i, (name, d) in enumerate(parts):
        out.append(Span(name, a, a + d, sid * 10 + i + 1, sid, 0, None,
                        dict(attrs) if name == "engine.dispatch" else {}))
        a += d
    return [Span("engine.step", t, a, sid, None, 0, None,
                 {"kind": kind, "k": k})] + out


def _parts(schedule, dispatch, sync, commit):
    return [("engine.schedule", schedule), ("engine.dispatch", dispatch),
            ("engine.sync", sync), ("engine.commit", commit)]


def _run(spans=None, trace=None):
    run = Run(cell={}, config=smoke_config(), window_s=10.0, end_s=10.0,
              setup_s=1.0, reqs=[_req(0, 0.5), _req(1, 1.0), _req(2, 2.0),
                                  _req(3, 11.0)],
              steps=[], trace=trace, traced_from=8.0)
    if spans is not None:
        run.spans = spans
    return run


SPANS = (
    _step(1, 0.5, _parts(0.001, 0.010, 0.150, 0.002), "prefill_chunk",
          tokens=100, lanes=2048, pairs=2048 * 2048, pairs_needed=60_000)
    + _step(2, 1.0, _parts(0.002, 0.060, 0.005, 0.001), "decode",
            tokens=3, lanes=8)
    + _step(3, 1.2, _parts(0.001, 0.020, 0.100, 0.003), "decode", k=4,
            tokens=12, lanes=32)
    + _step(4, 2.0, _parts(0.001, 0.010, 0.150, 0.002), "prefill_chunk",
            tokens=156, lanes=2048, pairs=2048 * 2048, pairs_needed=40_000)
    # profiled: after the sub-window opened, left out
    + _step(5, 8.5, _parts(0.5, 0.5, 0.5, 0.5), "prefill_chunk",
            tokens=1, lanes=2048, pairs=2048 * 2048, pairs_needed=1)
    + [Span("request.queue", 0.5, 0.51, 100, 1, 0, 0, {}),
       Span("request.queue", 1.0, 1.3, 101, 2, 0, 1, {}),
       Span("request.queue", 2.0, 2.0, 102, 4, 0, 2, {}),
       # request 1 preempted: it queued again
       Span("request.queue", 3.0, 3.1, 103, None, 0, 1, {}),
       # request 3 is due after the window
       Span("request.queue", 9.0, 9.9, 104, None, 0, 3, {})]
)


def test_readers_on_a_hand_made_run():
    run = _run(SPANS)
    assert sp.queue_wait_ms(run) == pytest.approx(
        1e3 * float(np.percentile([0.01, 0.4, 0.0], 80)))
    assert sp.prefill_lane_use(run) == pytest.approx(100 * 256 / 4096)
    assert sp.prefill_pair_use(run) == pytest.approx(
        100 * 100_000 / (2 * 2048 * 2048))
    # decode: 0.060 + 0.020 of dispatch over 1 + 4 iterations
    assert sp.decode_enqueue_ms(run) == pytest.approx(1e3 * 0.080 / 5)
    # each step's schedule and commit: 3, 3, 4, 3 ms
    assert sp.host_ms_per_step(run) == pytest.approx(13 / 4)
    trace = {"busy_s": 1.0, "window_s": 4.0, "kernels": {},
             "idle_by_host": {}, "idle_by_span": {"engine.dispatch": 1.5,
                                                  "engine.sync": 0.5,
                                                  sp.OUTSIDE: 0.2}}
    traced = _run(SPANS, trace)
    assert sp.idle_in_dispatch(traced) == pytest.approx(37.5)
    assert sp.idle_outside_engine(traced) == pytest.approx(5.0)
    # nothing outside the engine reads 0, not None
    del trace["idle_by_span"][sp.OUTSIDE]
    assert sp.idle_outside_engine(traced) == 0.0


@pytest.mark.parametrize("reader", [
    sp.queue_wait_ms, sp.prefill_lane_use, sp.prefill_pair_use,
    sp.decode_enqueue_ms, sp.host_ms_per_step, sp.idle_in_dispatch,
    sp.idle_outside_engine])
def test_readers_find_nothing_without_spans(reader):
    """A run that recorded no spans (the recorder off, or a program
    without it), and a trace without ``idle_by_span`` or without device
    time: None, never an error."""
    assert reader(_run()) is None
    bare = {"busy_s": 1.0, "window_s": 4.0, "kernels": {},
            "idle_by_host": {}}
    assert reader(_run(trace=bare)) is None
    cpu = {**bare, "busy_s": 0.0, "idle_by_span": {"engine.dispatch": 1.0}}
    assert reader(_run(trace=cpu)) is None


def test_window_spans_shift_to_the_window():
    spans = [Span("engine.step", 100.5, 100.75, 0, None, 0, None, {})]
    (s,) = sp.window_spans(spans, 100.0)
    assert (s.start, s.end) == (0.5, 0.75) and s.name == "engine.step"
