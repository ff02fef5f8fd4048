"""The span recorder inside the port's engine (``serving/tracing.py``):
off it records nothing; on, the engine's tokens, its virtual clock and
the Eq. 5 profiler's samples and fit are those of a run with it off;
each step's spans nest in order on both planes and through a verify
pass; each request's queue spans run from its submission (or its
preemption) to the entry of the step that admitted it, under its own id;
the dispatch's counts
are the shapes the chunk attention really scores; and under a
``torch.profiler`` session the engine's spans reach the trace as
``user_annotation`` events.

f32 on the CPU, at the smoke widths.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.request import Request
from repro_torch.models import attention
from repro_torch.models.build import Model
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import tracing
from repro_torch.serving.engine import EngineConfig, InferenceEngine

CFG = get_smoke_config("qwen7b")
torch.manual_seed(0)
MODEL = Model(CFG, device="cpu")
PARTS = ["engine.schedule", "engine.dispatch", "engine.sync",
         "engine.commit"]

# name -> (engine keywords, prompt lengths, outputs); the paged plane's
# cases run prefill chunks, K = 1 passes beside pending prompts and
# fused blocks; ``spec`` runs verify passes over repetitive prompts
CASES = {
    "paged": (dict(n_slots=3, max_len=40, prefill_batch=2, page_size=4,
                   chunk_size=8), (13, 5, 21, 9, 3), (6, 9, 4, 7, 5)),
    "slot": (dict(n_slots=3, max_len=40, prefill_batch=2, paged=False),
             (13, 5, 21, 9, 3), (6, 9, 4, 7, 5)),
    "spec": (dict(n_slots=2, max_len=48, prefill_batch=2, page_size=8,
                  chunk_size=16, decode_block=1, spec_decode=True,
                  max_spec_len=4), (20, 16, 24, 12), (10, 10, 8, 8)),
    "preempt": (dict(n_slots=2, max_len=16, prefill_batch=2, page_size=4,
                     chunk_size=8, n_pages=5), (10, 10), (6, 6)),
}


def _prompts(lens, repetitive=False):
    rng = np.random.default_rng(len(lens))
    if repetitive:
        return [np.tile(rng.integers(0, CFG.vocab_size, 4), n // 4)
                .astype(np.int32) for n in lens]
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in lens]


def _serve(case, fit_every=0):
    """The case's requests served to the end: (engine, requests)."""
    ekw, lens, outs = CASES[case]
    eng = InferenceEngine(MODEL, EngineConfig(**ekw))
    reqs = [Request.from_prompt(i, p, n) for i, (p, n) in
            enumerate(zip(_prompts(lens, case == "spec"), outs))]
    for r in reqs:
        eng.submit(r)
    for n in range(1, 500):
        if not (eng.queue or eng.prefilling or eng.active):
            break
        eng.step()
        if fit_every and n % fit_every == 0:
            eng.fit_profiler()
    return eng, reqs


@pytest.fixture
def recorder():
    tracing.drain()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.drain()


class _Ticks:
    """A ``perf_counter`` for the engine alone (the recorder keeps its
    own clock): each call advances by 1-7 ms in a fixed cycle, so a
    run's ``dt`` depend only on the engine's own stamps."""

    def __init__(self):
        self.n, self.t = 0, 0.0

    def perf_counter(self) -> float:
        self.n += 1
        self.t += 1e-3 * (1 + self.n % 7)
        return self.t


@pytest.mark.parametrize("case", ["paged", "slot", "spec"])
def test_off_records_nothing(case):
    tracing.drain()
    eng, _ = _serve(case, fit_every=3)
    assert not tracing.RECORDER.on and tracing.drain() == []
    assert eng._trace is None


@pytest.mark.parametrize("case", ["paged", "slot", "spec", "preempt"])
def test_on_leaves_tokens_clock_and_fit_unchanged(case, monkeypatch):
    """The same run with the recorder off and on, on an engine clock
    that only the engine's stamps advance: the same tokens, the same
    virtual clock, the same samples reach the profiler and the same
    coefficients come out of its fit."""
    from repro_torch.core.latency_model import FittedLatencyModel

    seen = []
    for name in ("observe_prefill", "observe_decode",
                 "observe_decode_block"):
        real = getattr(FittedLatencyModel, name)

        def observe(self, lens, dt, _real=real, _name=name):
            seen.append((_name, repr(lens), dt))
            return _real(self, lens, dt)

        monkeypatch.setattr(FittedLatencyModel, name, observe)
    runs = []
    for on in (False, True):
        monkeypatch.setattr(engine_mod, "time", _Ticks())
        seen.clear()
        tracing.drain()
        if on:
            tracing.enable()
        try:
            eng, reqs = _serve(case, fit_every=4)
            fitted = eng.fit_profiler()
        finally:
            tracing.disable()
        spans = tracing.drain()
        assert bool(spans) == on
        runs.append(([r.generated for r in reqs], eng.clock, list(seen),
                     fitted, dataclasses.asdict(eng.profiler.coeffs),
                     eng.n_dispatches, eng.n_prefill_tokens))
    assert runs[0] == runs[1]
    assert runs[0][3]   # the profiler did fit


def _tree(spans):
    steps = [s for s in spans if s.name == "engine.step"]
    kids = {}
    for s in spans:
        if s.name in PARTS:
            kids.setdefault(s.parent, []).append(s)
    return steps, kids


@pytest.mark.parametrize("case", ["paged", "slot", "spec", "preempt"])
def test_step_spans_nest_in_order(case, recorder):
    eng, _ = _serve(case, fit_every=4)
    spans = recorder.drain()
    steps, kids = _tree(spans)
    assert len(steps) == eng.n_dispatches + sum(
        s.attrs["kind"] == "idle" for s in steps)
    for st in steps:
        parts = kids[st.sid]
        names = [p.name for p in parts]
        assert names == (PARTS if st.attrs["kind"] != "idle"
                         else PARTS[:1])
        assert parts[0].start == st.start and parts[-1].end == st.end
        for a, b in zip(parts, parts[1:]):
            assert a.end == b.start and a.start <= a.end
        assert {p.engine for p in parts} == {st.engine} == {eng.trace_id}
    fits = [s for s in spans if s.name == "engine.fit_profiler"]
    assert fits and all(s.parent is None and s.start <= s.end for s in fits)
    if case == "spec":
        assert eng.n_spec_dispatches > 0
        verify = [p for st in steps for p in kids[st.sid]
                  if p.name == "engine.dispatch"
                  and p.attrs["lanes"] % eng.cfg.n_slots == 0
                  and p.attrs["lanes"] // eng.cfg.n_slots > 1]
        assert verify
    by_kind = {}
    for st in steps:
        by_kind.setdefault(st.attrs["kind"], []).append(st)
    want = {"paged": {"prefill_chunk", "decode"},
            "slot": {"prefill", "decode"}, "spec": {"prefill_chunk",
                                                    "decode"},
            "preempt": {"prefill_chunk", "decode"}}[case]
    assert want <= set(by_kind)


@pytest.mark.parametrize("case", ["paged", "slot", "spec", "preempt"])
def test_queue_spans_run_from_submit_to_admission(case, recorder):
    """Each request queues once from its submission to the entry of the
    step that admitted it, and again after a recompute preemption, from
    the entry of the step that preempted it; no other request span."""
    ekw, lens, outs = CASES[case]
    eng = InferenceEngine(MODEL, EngineConfig(**ekw))
    reqs = [Request.from_prompt(i, p, n) for i, (p, n) in
            enumerate(zip(_prompts(lens, case == "spec"), outs))]
    submitted = []
    for r in reqs:
        submitted.append(tracing.now())
        eng.submit(r)
    eng.run_until_done()
    spans = recorder.drain()
    steps = {s.sid: s for s in spans if s.name == "engine.step"}
    assert {s.name for s in spans if s.rid is not None} == {"request.queue"}
    for r, t in zip(reqs, submitted):
        mine = [s for s in spans if s.rid == r.rid]
        assert mine and t <= mine[0].start
        assert mine[0].start < steps[mine[0].parent].start
        for s in mine:
            assert s.engine == eng.trace_id
            assert s.end == steps[s.parent].start
        for a, b in zip(mine, mine[1:]):    # preempted by a later step
            assert a.end < b.start and b.start in {
                st.start for st in steps.values()}
    assert not tracing.RECORDER._queued    # every request admitted
    n_queued = [sum(s.rid == r.rid for s in spans) for r in reqs]
    assert (max(n_queued) >= 2) == (case == "preempt")


@pytest.mark.parametrize("case", ["paged", "spec", "preempt"])
def test_dispatch_counts_are_the_scored_shapes(case, recorder, monkeypatch):
    """Each prefill chunk's ``lanes`` and ``pairs`` are the lanes and
    the (lane, key) pairs every ``paged_chunk_attention`` call of that
    step scores, ``pairs_needed`` those of its real tokens under the
    causal mask; Σ ``tokens`` over the chunks is ``n_prefill_tokens``."""
    calls = []
    real = attention.paged_chunk_attention

    def scored(q, k_pages, v_pages, page_table, *, q_pos, kv_len, **kw):
        b, _, c, _ = q.shape
        keys = page_table.shape[1] * k_pages.shape[2]
        live = q_pos < kv_len[:, None]
        calls.append((b * c, b * c * keys, int((q_pos + 1)[live].sum())))
        return real(q, k_pages, v_pages, page_table, q_pos=q_pos,
                    kv_len=kv_len, **kw)

    monkeypatch.setattr(attention, "paged_chunk_attention", scored)
    ekw, lens, outs = CASES[case]
    eng = InferenceEngine(MODEL, EngineConfig(**ekw))
    for i, (p, n) in enumerate(zip(_prompts(lens, case == "spec"), outs)):
        eng.submit(Request.from_prompt(i, p, n))
    n_chunks, tokens = 0, 0
    while eng.queue or eng.prefilling or eng.active:
        mark = len(calls)
        ev = eng.step()
        spans = recorder.drain()
        if ev["kind"] != "prefill_chunk":
            continue
        n_chunks += 1
        (d,) = [s for s in spans if s.name == "engine.dispatch"]
        mine = calls[mark:]
        assert len(mine) == CFG.n_layers
        assert set(mine) == {(d.attrs["lanes"], d.attrs["pairs"],
                              d.attrs["pairs_needed"])}
        assert d.attrs["tokens"] == ev["tokens"] > 0
        tokens += d.attrs["tokens"]
    assert n_chunks > 0 and tokens == eng.n_prefill_tokens


@pytest.mark.parametrize("on", [True, False])
def test_profiler_session_holds_engine_spans(on, tmp_path):
    """Under a CPU ``torch.profiler`` session the engine's spans reach
    the trace as ``user_annotation`` events (request spans never do);
    with the recorder off, none."""
    from torch.profiler import ProfilerActivity, profile

    tracing.drain()
    if on:
        tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng, _ = _serve("paged", fit_every=4)
    finally:
        tracing.disable()
    spans = tracing.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in notes}
    if not on:
        assert not names & {"engine.step", *PARTS}
        return
    assert {"engine.step", "engine.fit_profiler", *PARTS} <= names
    assert not any(n.startswith("request.") for n in names)
    n_steps = sum(s.name == "engine.step" for s in spans)
    assert sum(e["name"] == "engine.step" for e in notes) == n_steps
    # each part inside its step on the profiler's clock too
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in notes
                   if e["name"] == "engine.step")
    for e in notes:
        if e["name"] in PARTS:
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b + 1
                       for a, b in steps)
