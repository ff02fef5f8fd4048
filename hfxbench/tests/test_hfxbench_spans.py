"""The readings of the program's spans (``hfxbench/spans.py``): the idle
time of a device trace put down to engine spans, on a hand-made event
list, and adding up to the sub-window's idle time on the trace's clock;
each reader on a hand-made run, and None on a run without spans;
``summarize`` unmoved by the spans' events but for its ``idle_by_span``;
the steps given their dispatch's attributes and their spans' seconds, or
neither where the spans and the steps do not pair."""

import numpy as np
import pytest

from hfxbench import spans as sp
from hfxbench.harness import Run, Step
from hfxbench.tests.conftest import smoke_config
from hfxbench.trace import MARK, summarize
from hfxbench.traffic import Req
from repro_torch.serving.tracing import Span


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# the sub-window [-5, 145] (us); device busy [0, 10], [20, 30], [50, 60],
# [100, 110], [130, 140]
EVENTS = [
    _x("user_annotation", MARK, -5, 150),
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
    # the second step's dispatch; the marker's edges (-5, 0) and
    # (140, 145): no engine span
    got = summarize(EVENTS, 150e-6)["idle_by_span"]
    assert got == pytest.approx({"engine.dispatch": (10 + 20 + 20) / 1e6,
                                 "engine.sync": 40 / 1e6,
                                 sp.OUTSIDE: (5 + 5) / 1e6})
    assert "python" not in got and "request.queue" not in got


def test_summarize_unmoved_by_span_events():
    """The spans' ``user_annotation`` events change none of summarize's
    keys: busy time, operations by name and idle time by host call."""
    plain = [e for e in EVENTS
             if e["cat"] != "user_annotation" or e["name"] == MARK]
    keys = ("busy_s", "window_s", "wall_s", "outside_s", "kernels",
            "idle_by_host")
    got, want = summarize(EVENTS, 140e-6), summarize(plain, 140e-6)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


# device operations stamped across the marker's edges and beyond it
EDGES = [_x("kernel", "gemm", -20, 17), _x("gpu_memset", "fill", -9, 6),
         _x("kernel", "attn", 143, 10), _x("gpu_memcpy", "late", 160, 4)]


@pytest.mark.parametrize("extra", [[], EDGES], ids=["inside", "edges"])
@pytest.mark.parametrize("wall_s", [150e-6, 120e-6, 200e-6])
def test_idle_split_adds_up_to_the_idle_time(extra, wall_s):
    """On the trace's clock, the idle time split by engine span and by
    host call each add up to the sub-window's idle time, ``window_s``
    less ``busy_s``, whatever the host's clock read for the sub-window:
    the marker, widened to hold every device operation, is the window,
    and the device time stamped outside the marker is read apart."""
    got = summarize(EVENTS + extra, wall_s)
    assert got["wall_s"] == wall_s
    idle = got["window_s"] - got["busy_s"]
    assert sum(got["idle_by_span"].values()) == pytest.approx(idle)
    assert sum(got["idle_by_host"].values()) == pytest.approx(idle)
    if extra:
        # [-20, 164]; busy 17 + 5 x 10 + 10 + 4
        assert got["window_s"] == pytest.approx(184e-6)
        assert got["busy_s"] == pytest.approx(81e-6)
        # before -5: 15 of the first gemm's union with the fill; after
        # 145: 8 of the attention and the copy's 4
        assert got["outside_s"] == pytest.approx((15 + 8 + 4) / 1e6)
        assert got["kernels"]["fill"] == {"s": pytest.approx(6e-6), "n": 1}
        assert got["kernels"]["late"] == {"s": pytest.approx(4e-6), "n": 1}
        # (-3, 0) and (153, 160) under no engine span, (140, 143) under
        # the second step
        assert got["idle_by_span"][sp.OUTSIDE] == pytest.approx(10e-6)
        assert got["idle_by_span"]["engine.step"] == pytest.approx(3e-6)
    else:
        assert got["window_s"] == pytest.approx(150e-6)
        assert got["busy_s"] == pytest.approx(50e-6)
        assert got["outside_s"] == 0.0


def test_a_device_operation_stamped_before_its_launch_is_read():
    """``early_s``: how far the trace puts a device operation before the
    runtime call that launched it (0 where none is early)."""
    def linked(e, c):
        return {**e, "args": {"correlation": c}}

    launches = [linked(_x("cuda_runtime", "cudaLaunchKernel", 8, 2), 1),
                linked(_x("cuda_runtime", "cudaGraphLaunch", 97, 4), 2)]
    ops = [linked(EVENTS[1], 1), linked(EVENTS[4], 2)]   # at 0 and 100
    assert summarize(EVENTS + launches + ops, 150e-6)["early_s"] == (
        pytest.approx(8e-6))
    assert summarize(EVENTS, 150e-6)["early_s"] == 0.0


def test_a_trace_without_the_marker_is_read_over_its_device_extent():
    """Without the sub-window's marker the device operations' extent on
    the trace's clock is the window, whatever the host's clock read: only
    the gaps between device operations are idle."""
    bare = [e for e in EVENTS if e["name"] != MARK]
    got = summarize(bare, 120e-6)
    assert got["window_s"] == pytest.approx(140e-6)
    idle = got["window_s"] - got["busy_s"]
    assert idle == pytest.approx(90e-6)
    assert sum(got["idle_by_span"].values()) == pytest.approx(idle)
    assert sum(got["idle_by_host"].values()) == pytest.approx(idle)
    assert sp.OUTSIDE not in got["idle_by_span"]


def test_summarize_splits_idle_time_by_engine_span():
    got = summarize(EVENTS, 140e-6)
    assert sum(got["idle_by_span"].values()) == pytest.approx(
        sum(got["idle_by_host"].values()))


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


def _steps_of(spans):
    """The harness's steps that the spans' ``engine.step`` spans record."""
    return [Step(s.attrs["kind"], s.start, s.end, 0, s.attrs["k"],
                 s.start >= 8.0, [], 0)
            for s in spans if s.name == "engine.step"]


def _run(spans=None, trace=None, steps=None):
    """A run whose steps are those the spans record, each given its
    dispatch's attributes (``steps`` given: those, as they are)."""
    if steps is None:
        steps = [] if spans is None else _steps_of(spans)
        if spans is not None:
            assert sp.attach(steps, spans) is None
    return Run(cell={}, config=smoke_config(), window_s=10.0, end_s=10.0,
               setup_s=1.0, reqs=[_req(0, 0.5), _req(1, 1.0), _req(2, 2.0),
                                  _req(3, 11.0)],
               steps=steps, trace=trace, traced_from=8.0, spans=spans)


SPANS = (
    _step(1, 0.5, _parts(0.001, 0.010, 0.150, 0.002), "prefill_chunk",
          tokens=100, lanes=2048, pairs=2048 * 2048, pairs_needed=60_000)
    + _step(2, 1.0, _parts(0.002, 0.060, 0.005, 0.001), "decode",
            tokens=3, lanes=8, graph=0)
    + _step(3, 1.2, _parts(0.001, 0.020, 0.100, 0.003), "decode", k=4,
            tokens=12, lanes=32, graph=1)
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
    # the mean of requests 0-2's summed waits; request 3 is due later
    assert sp.queue_wait_ms(run) == pytest.approx(1e3 * 0.41 / 3)
    assert sp.prefill_lane_use(run) == pytest.approx(100 * 256 / 4096)
    assert sp.prefill_pair_use(run) == pytest.approx(
        100 * 100_000 / (2 * 2048 * 2048))
    # decode: 0.060 + 0.020 of dispatch over 1 + 4 iterations
    assert sp.decode_enqueue_ms(run) == pytest.approx(1e3 * 0.080 / 5)
    # each step's schedule and commit: 3, 3, 4, 3 ms
    assert sp.host_ms_per_step(run) == pytest.approx(13 / 4)
    # 4 of the 1 + 4 decode iterations replayed the graph
    assert sp.decode_graph_share(run) == pytest.approx(80.0)
    trace = {"busy_s": 1.0, "window_s": 4.0, "kernels": {},
             "idle_by_host": {}, "idle_by_span": {"engine.dispatch": 1.5,
                                                  "engine.sync": 0.5,
                                                  "engine.commit": 0.8,
                                                  sp.OUTSIDE: 0.2}}
    traced = _run(SPANS, trace)
    assert sp.idle_in_dispatch(traced) == pytest.approx(37.5)
    assert sp.idle_outside_engine(traced) == pytest.approx(5.0)
    # nothing outside the engine reads 0, not None
    del trace["idle_by_span"][sp.OUTSIDE]
    assert sp.idle_outside_engine(traced) == 0.0


READERS = [sp.queue_wait_ms, sp.prefill_lane_use, sp.prefill_pair_use,
           sp.decode_graph_share, sp.decode_enqueue_ms, sp.host_ms_per_step,
           sp.idle_in_dispatch, sp.idle_outside_engine]
# the readers of the steps' counters and spans (Step.dispatch, .parts)
COUNTED = [sp.prefill_lane_use, sp.prefill_pair_use, sp.decode_graph_share,
           sp.decode_enqueue_ms, sp.host_ms_per_step]


@pytest.mark.parametrize("reader", READERS)
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


def test_steps_get_their_dispatch_attributes_unchanged():
    """Each step gets a copy of its dispatch span's attributes, whatever
    keys the program put there; a step that dispatched nothing gets {}."""
    spans = SPANS + _step(6, 3.0, [("engine.schedule", 0.001)], "idle")
    steps = _steps_of(spans)
    assert sp.attach(steps, spans) is None
    assert [s.dispatch for s in steps[:3]] == [
        {"tokens": 100, "lanes": 2048, "pairs": 2048 * 2048,
         "pairs_needed": 60_000},
        {"tokens": 3, "lanes": 8, "graph": 0},
        {"tokens": 12, "lanes": 32, "graph": 1}]
    assert steps[-1].kind == "idle" and steps[-1].dispatch == {}
    probe = _step(7, 4.0, _parts(0.001, 0.01, 0.01, 0.001), "decode",
                  lanes=8, graph=1, experts_touched=(3, 40))
    (step,) = _steps_of(probe)
    assert sp.attach([step], probe) is None
    assert step.dispatch["experts_touched"] == (3, 40)
    assert step.dispatch is not probe[2].attrs   # a copy
    assert step.parts == pytest.approx({
        "engine.step": 0.022, "engine.schedule": 0.001,
        "engine.dispatch": 0.01, "engine.sync": 0.01,
        "engine.commit": 0.001})


def _drop_first_step(spans):
    first = next(s for s in spans if s.name == "engine.step")
    return [s for s in spans if s is not first]


def _relabel_first_step(spans):
    first = next(s for s in spans if s.name == "engine.step")
    return [s._replace(attrs={**s.attrs, "kind": "decode"}) if s is first
            else s for s in spans]


@pytest.mark.parametrize("skew", [_drop_first_step, _relabel_first_step])
def test_unpaired_spans_leave_every_step_without_counters(skew):
    """Spans that do not pair with the steps one to one, by count or by
    kind: no step gets counters, the reason is given, and the readers of
    the counters find nothing."""
    steps = _steps_of(SPANS)
    why = sp.attach(steps, skew(SPANS))
    assert why and all(s.dispatch is None and s.parts is None
                       for s in steps)
    run = _run(SPANS, steps=steps)
    for reader in COUNTED:
        assert reader(run) is None


def test_the_sub_window_marks_itself_on_the_trace():
    """A profiled sub-window on the CPU carries its marker: its length on
    the trace's clock holds the host's, by little more than the
    profiler's own calls; nothing lies outside it, and its idle time is
    put down to the engine span that held it."""
    import time

    import torch

    from hfxbench.trace import SubWindow

    sub = SubWindow(0.0, 2, cuda=False)
    sub.before_step(0.0, lambda: None)
    for _ in range(2):
        with torch.profiler.record_function("engine.step"):
            time.sleep(0.02)
        sub.after_step(lambda: None)
    got = sub.summary()
    assert got["wall_s"] >= 0.04
    assert got["wall_s"] <= got["window_s"] <= got["wall_s"] + 0.02
    assert got["busy_s"] == 0.0 and got["outside_s"] == 0.0
    assert set(got["idle_by_span"]) <= {"engine.step", sp.OUTSIDE}
    assert sum(got["idle_by_span"].values()) == pytest.approx(
        got["window_s"])
