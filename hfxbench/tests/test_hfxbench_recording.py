"""The program's spans in a run of the harness on the CPU at the smoke
width: a traced run records the window's spans and gives each step its
dispatch's attributes, whatever the program puts there; an untraced run
never turns the recorder on; the recorder is off after every run, also
one that raises; spans that do not pair with the steps give no step any
counters."""

import io
import time

import pytest

from hfxbench import catalog, harness
from hfxbench.tests.conftest import smoke_cell, smoke_config, smoke_mix
from repro_torch.serving import tracing
from repro_torch.serving.engine import InferenceEngine

# the readers of the steps' counters (Step.dispatch)
COUNTED = ("engine.prefill_lane_use", "model.prefill_attn_pair_use",
           "engine.decode_graph_share.tail")


def _run(mp, trace: bool):
    """(result line, the Run its readers got, what it printed).  The
    profiled sub-window opens at the window's close, if steps remain, so
    that the steps' readers read the whole window."""
    seen = []
    real = catalog.reader

    def reader(name, root=catalog.ROOT):
        read = real(name, root)

        def spy(run):
            seen.append(run)
            return read(run)
        return spy

    mp.setattr(catalog, "reader", reader)
    log = io.StringIO()
    cell = smoke_cell()
    cell["trace"]["start_frac"] = 1.0
    res = harness.run_cell(cell, smoke_config(), smoke_mix(),
                           seed=2 ** 31 + 7, seconds=1.5, trace=trace,
                           device="cpu", t_start=time.perf_counter(),
                           bench=catalog.load_benchmark(), log=log)
    assert seen and all(r is seen[0] for r in seen)
    return res, seen[0], log.getvalue()


@pytest.fixture(scope="module")
def traced():
    with pytest.MonkeyPatch.context() as mp:
        return _run(mp, True)


def test_traced_run_records_the_window_alone(traced):
    """Spans from the window's opening on (the smoke cell has no
    pre-roll): none of the warm-up's or the profiler fit's steps, one
    ``engine.step`` span for each step the harness drove."""
    _, run, _ = traced
    assert run.spans
    assert min(s.start for s in run.spans) >= 0.0
    roots = [s for s in run.spans if s.name == "engine.step"]
    assert len(roots) == len(run.steps)
    assert [s.attrs["kind"] for s in roots] == [s.kind for s in run.steps]
    assert {s.name for s in run.spans} >= {
        "engine.step", "engine.dispatch", "engine.sync", "request.queue"}


def test_every_step_gets_its_dispatch(traced):
    _, run, _ = traced
    eng = smoke_config()["engine"]
    kinds = {s.kind for s in run.steps}
    assert {"prefill_chunk", "decode"} <= kinds
    for s in run.steps:
        assert isinstance(s.dispatch, dict)
        # the step's span holds its parts, on the recorder's clock
        assert s.parts["engine.step"] >= sum(
            v for n, v in s.parts.items() if n != "engine.step") - 1e-9
        if s.kind == "prefill_chunk":
            assert s.dispatch["lanes"] == eng["n_slots"] * eng["chunk_size"]
            assert s.dispatch["tokens"] == s.tokens > 0
            assert s.dispatch["pairs"] >= s.dispatch["pairs_needed"] > 0
        elif s.kind == "decode":
            assert s.dispatch["lanes"] == eng["n_slots"] * s.k
            assert s.dispatch["graph"] == 0   # no graph on the CPU


def test_traced_run_reads_the_span_metrics(traced):
    """The counters' and the spans' readers read the CPU run; the device
    trace's find nothing on the CPU.  (On a loaded host the window may
    hold no decode step: then the graph's share has nothing to read.)"""
    res, run, log = traced
    got = res["metrics"]
    assert {"engine.prefill_lane_use", "model.prefill_attn_pair_use",
            "engine.queue_wait_ms"} <= set(got)
    if run.window_steps("decode"):
        assert got["engine.decode_graph_share.tail"]["value"] == 0.0
    else:
        assert "engine.decode_graph_share.tail" not in got
    assert 0 < got["engine.prefill_lane_use"]["value"] <= 100
    assert 0 < got["model.prefill_attn_pair_use"]["value"] <= 100
    assert got["engine.queue_wait_ms"]["value"] >= 0
    assert not {"device.idle_in_dispatch.tail",
                "device.idle_outside_engine.tail"} & set(got)
    assert "spans:" not in log


def test_recorder_off_after_a_traced_run(traced):
    assert not tracing.RECORDER.on and tracing.RECORDER.spans == []


def test_recorder_off_after_a_run_that_raises(monkeypatch):
    real = harness._drive
    calls = []

    def drive(*args, **kwargs):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("a step failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(harness, "_drive", drive)
    with pytest.raises(RuntimeError, match="a step failed"):
        _run(monkeypatch, True)
    assert not tracing.RECORDER.on and tracing.RECORDER.spans == []


def test_untraced_run_records_nothing(monkeypatch):
    """``--trace 0`` never turns the recorder on: no step of the run sees
    it on, nothing is recorded, and no step gets counters."""
    def enable():
        raise AssertionError("the recorder was turned on")

    real = InferenceEngine.step
    on = []

    def step(self):
        on.append(tracing.RECORDER.on)
        return real(self)

    monkeypatch.setattr(tracing, "enable", enable)
    monkeypatch.setattr(InferenceEngine, "step", step)
    res, run, _ = _run(monkeypatch, False)
    assert res["correct"] is True
    assert on and not any(on)
    assert run.spans is None and tracing.RECORDER.spans == []
    assert all(s.dispatch is None and s.parts is None for s in run.steps)


def test_an_attribute_the_program_adds_reaches_the_step(monkeypatch):
    """A counter that the program puts on its dispatch span reaches
    ``Step.dispatch`` as it was put there: the path a configuration's
    own counters take to a metric file."""
    real = InferenceEngine._timed

    def timed(self, call, lanes, graph=False, **attrs):
        return real(self, call, lanes, graph, probe=("probe", int(lanes)),
                    **attrs)

    monkeypatch.setattr(InferenceEngine, "_timed", timed)
    res, run, _ = _run(monkeypatch, True)
    assert res["correct"] is True
    dispatched = [s for s in run.steps if s.dispatch]
    assert dispatched
    for s in dispatched:
        assert s.dispatch["probe"] == ("probe", s.dispatch["lanes"])


def test_unpaired_spans_give_no_step_counters(monkeypatch):
    """One step's span lost: the harness says why, no step gets counters,
    and the counters' readers report nothing; the run stays correct."""
    real = harness.spans.window_spans

    def lose_one(spans, base):
        out = real(spans, base)
        first = next(i for i, s in enumerate(out) if s.name == "engine.step")
        return out[:first] + out[first + 1:]

    monkeypatch.setattr(harness.spans, "window_spans", lose_one)
    res, run, log = _run(monkeypatch, True)
    assert res["correct"] is True
    assert all(s.dispatch is None and s.parts is None for s in run.steps)
    assert "spans: no step gets its spans' readings" in log
    assert not set(COUNTED) & set(res["metrics"])
    assert "engine.queue_wait_ms" in res["metrics"]
