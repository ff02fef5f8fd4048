"""One run of one cell: set-up, the open-loop window, the check, the
result line.

The window drives the port's ``InferenceEngine`` on its paged plane
(``submit`` + ``step``) from one thread on the host's clock: a request
is submitted when it falls due, ``step()`` is called while the engine
holds work, and the loop sleeps to the next due time otherwise.  Every
token is stamped when the ``step()`` that produced it returns, which is
when a client would receive it, and a request's TTFT runs from when it
was due.  The profiler that the engine's Eq. 5 budget reads is refitted
every 25 steps, as ``chip_smoke.py``'s ``step_until_idle`` does.

Each step is recorded as a span by the kind it returns, with the rows it
served: ``(start, take)`` of each prompt chunk of a prefill step (read
from the requests' prefill progress), ``(position, tokens emitted)`` of
each row of a decode step.  Metric readers (``metrics/<name>.py``) take
the :class:`Run` and return a number or None.

A traced run (``--trace 1``) also records the program's own spans
(``repro_torch.serving.tracing``) from the end of the warm-up to the
loop's end: ``Run.spans``, and on each step the attributes of its
``engine.dispatch`` span, ``Step.dispatch``, and the seconds of its
spans, ``Step.parts`` (``hfxbench/spans.py``).  An
untraced run leaves the recorder off.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import sys
import time
from typing import Optional

import numpy as np

from hfxbench import catalog, check, model, slo, spans, traffic
from hfxbench.trace import SubWindow, breakdown
from hfxbench.traffic import Req

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FIT_EVERY = 25          # steps between refits of the engine's profiler
MAX_IDLE_STEPS = 1000   # an engine that holds work but idles this long
# warm-up: prompt lengths of the requests that fit the engine's profiler
FIT_PROMPTS = (40, 90, 150, 220, 300)
FIT_OUT = 10


@dataclasses.dataclass
class Step:
    kind: str
    t0: float
    t1: float
    tokens: int
    k: int
    traced: bool
    rows: list            # prefill: (start, take); decode: (pos0, emitted)
    emitted: int          # tokens delivered to clients by the step
    n_completed: int = 0  # prefill rows whose prompt completed
    # traced runs: the attributes of the step's engine.dispatch span
    # ({} for none), and the seconds of its engine.step span and of each
    # of its parts; None where the program's spans were not recorded
    dispatch: Optional[dict] = None
    parts: Optional[dict] = None

    @property
    def span(self) -> float:
        return self.t1 - self.t0

    def decode_iters(self) -> list[tuple[list[int], list[int]]]:
        """Per decode iteration: the KV lengths of the rows emitting a
        token in it, and of every row the iteration's attention reads (a
        row that stopped inside a fused block keeps its length)."""
        out = []
        for i in range(self.k):
            emit = [p + i + 1 for p, n in self.rows if i < n]
            read = [p + i + 1 if i < n else p + n for p, n in self.rows]
            out.append((emit, read))
        return out


@dataclasses.dataclass
class Run:
    """What a metric reader gets."""

    cell: dict
    config: dict
    window_s: float
    end_s: float
    setup_s: float
    reqs: list[Req]
    steps: list[Step]
    trace: Optional[dict]   # the sub-window's summary (traced runs)
    traced_from: Optional[float] = None   # when the sub-window began
    spans: Optional[list] = None   # the program's spans (traced runs)

    @functools.cached_property
    def counts(self):
        """The configuration's FLOP and byte counts (its family's)."""
        return model.family(self.config).counts(self.config)

    def due_in_window(self) -> list[Req]:
        return [r for r in self.reqs if 0.0 <= r.due < self.window_s]

    @property
    def span_s(self) -> float:
        """The part of the window that step metrics read: all of it, or
        in a traced run the part before the profiled sub-window."""
        return min(self.window_s, self.traced_from or self.window_s)

    def window_steps(self, kind: Optional[str] = None) -> list[Step]:
        """Steps that began in the window, before any profiled step."""
        return [s for s in self.steps
                if 0.0 <= s.t0 < self.span_s
                and (kind is None or s.kind == kind)]

    def traced_steps(self, kind: Optional[str] = None) -> list[Step]:
        return [s for s in self.steps
                if s.traced and (kind is None or s.kind == kind)]


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _drive(engine, by_rid: dict, t: float, steps: list, pending: dict,
           traced: bool, clock) -> None:
    """One ``engine.step()``, recorded."""
    before = {rid: er.prefill_progress for rid, (_, er) in pending.items()}
    ev = engine.step()
    t1 = clock()
    rows, emitted = [], {}
    for rid, _tok, _ in ev.get("token_events", ()):
        emitted[rid] = emitted.get(rid, 0) + 1
    if ev["kind"] == "prefill_chunk":
        for rid, (r, er) in pending.items():
            take = er.prefill_progress - before[rid]
            if take > 0:
                rows.append((before[rid], take))
                if r.began is None:
                    r.began = t
    elif ev["kind"] == "decode":
        rows = [(by_rid[rid].l_in + len(by_rid[rid].tokens) - 1, n)
                for rid, n in emitted.items()]
    for rid, tok, _ in ev.get("token_events", ()):
        r = by_rid[rid]
        r.tokens.append(int(tok))
        if r.first is None:
            r.first = t1
            pending.pop(rid, None)
        r.last = t1
    steps.append(Step(ev["kind"], t, t1, int(ev.get("tokens", 0)),
                      int(ev.get("k", 1)), traced, rows,
                      len(ev.get("token_events", ())), n_completed=int(ev.get("n_completed", 0))))


def open_loop(engine, reqs: list[Req], *, window_s: float, base: float,
              drain_s: Optional[float], sub: Optional[SubWindow],
              device) -> tuple[list[Step], float, dict]:
    """Run the schedule against ``engine``; times are seconds from the
    window's opening, ``base`` on ``time.perf_counter`` (a pre-roll runs
    before it).  ``drain_s`` None: stop when the window closes;
    else keep stepping after it (no more submissions) until every
    request is finished or ``drain_s`` has passed.  Returns the steps,
    the stop time and the engine's requests by id."""
    from repro_torch.core.request import Request

    def clock():
        return time.perf_counter() - base

    stop_at = window_s + (drain_s or 0.0)
    by_rid = {r.rid: r for r in reqs}
    engine_reqs: dict[int, Request] = {}
    pending: dict[int, tuple] = {}
    steps: list[Step] = []
    sendable = [r for r in reqs if r.due < window_s]
    i, idle, n_steps = 0, 0, 0
    while True:
        t = clock()
        while i < len(sendable) and sendable[i].due <= t:
            r = sendable[i]
            er = Request.from_prompt(r.rid, r.prompt, r.l_out, task=r.task,
                                     ttft_slo=r.ttft_slo,
                                     tpot_slo=r.tpot_slo, arrival=r.due)
            engine.submit(er)
            r.submitted = clock()
            engine_reqs[r.rid] = er
            pending[r.rid] = (r, er)
            i += 1
        if t >= stop_at or (drain_s is None and t >= window_s):
            break
        if not (engine.queue or engine.prefilling or engine.active):
            if i >= len(sendable):
                if t >= window_s:
                    break
                time.sleep(min(stop_at, window_s) - t)
            else:
                time.sleep(max(0.0, min(sendable[i].due, stop_at) - t))
            continue
        traced = False
        if sub is not None:
            sub.before_step(t, lambda: _sync(device))
            traced = sub.active()
            t = clock()
        _drive(engine, by_rid, t, steps, pending, traced, clock)
        if sub is not None:
            sub.after_step(lambda: _sync(device))
        idle = idle + 1 if steps[-1].kind == "idle" else 0
        if idle > MAX_IDLE_STEPS:
            raise RuntimeError("the engine holds work but makes no progress")
        n_steps += 1
        if n_steps % FIT_EVERY == 0:
            engine.fit_profiler()
    end = clock()
    if sub is not None:
        sub.stop(lambda: _sync(device))
    return steps, end, engine_reqs


def warm_up(mdl, cfg: dict, seed: int, sub: Optional[SubWindow]):
    """Every shape the window uses, then a fresh engine whose profiler
    is fitted on a few steady requests (so Eq. 5 budgets the first
    chunk of the window).  Returns that engine."""
    eng = model.build_engine(mdl, cfg)
    eng.warm_decode_blocks()
    rng = traffic.rng_for(seed, 4)
    vocab = cfg["vocab_size"]
    chunk = cfg["engine"]["chunk_size"]

    def serve(engine, lens, l_out):
        from repro_torch.core.request import Request

        for j, l_in in enumerate(lens):
            prompt = rng.integers(0, vocab, l_in).astype(np.int32)
            engine.submit(Request.from_prompt(j, prompt, l_out))
        for _ in range(100_000):
            if not (engine.queue or engine.prefilling or engine.active):
                return
            engine.step()
        raise RuntimeError("warm-up did not drain")

    # a full chunk, a decode step beside a pending prompt, fused blocks
    serve(eng, [chunk + 1] * 2, 4)
    if sub is not None:
        sub.warm(lambda: serve(eng, [chunk + 1], 2))
    del eng
    eng = model.build_engine(mdl, cfg)
    max_prompt = cfg["engine"]["max_len"] // 2
    serve(eng, [min(p, max_prompt) for p in FIT_PROMPTS],
          min(FIT_OUT, max_prompt))
    if not eng.fit_profiler():
        raise RuntimeError("the engine's profiler did not fit in warm-up")
    return eng


def mismatches(reqs: list[Req], engine_reqs: dict) -> int:
    """Requests whose served stream differs from what the engine
    recorded, or that the engine finished at another length."""
    from repro_torch.core.request import RequestState

    by_rid = {r.rid: r for r in reqs}
    bad = 0
    for rid, er in engine_reqs.items():
        r = by_rid[rid]
        done = er.state == RequestState.FINISHED
        if (list(er.generated or []) != r.tokens or done != r.finished
                or (done and len(r.tokens) != r.l_out)):
            bad += 1
    return bad


def window(cell: dict, engine, mix: dict, cfg: dict, *, seed: int,
           seconds: float, sub: Optional[SubWindow], device,
           opened=None):
    """The cell's schedule for ``seed`` served by ``engine``: (requests,
    steps, stop time, the engine's requests, the engine's queues when
    the loop stopped).  ``opened`` is called when the set-up ends, with
    the window's opening on ``time.perf_counter``: then, or after the
    cell's pre-roll."""
    preroll = cell.get("preroll_s", 0.0)
    reqs = traffic.schedule(mix, rate=cell["rate_rps"], window_s=seconds,
                            seed=seed, vocab=cfg["vocab_size"],
                            preroll_s=preroll,
                            preroll_burst=cell.get("preroll_burst", 0))
    _sync(device)
    base = time.perf_counter() + preroll
    if opened is not None:
        opened(base)
    steps, end, engine_reqs = open_loop(
        engine, reqs, window_s=seconds, base=base,
        drain_s=cell["drain_s"] if cell["judge"] == "tail" else None,
        sub=sub, device=device)
    at_close = {"queued": len(engine.queue),
                "prefilling": len(engine.prefilling),
                "active": len(engine.active),
                "profiler": dataclasses.asdict(engine.profiler.coeffs)}
    return reqs, steps, end, engine_reqs, at_close


def run_cell(cell: dict, cfg: dict, mix: dict, *, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             bench: dict, log=sys.stderr) -> dict:
    """Set up, run the window, judge, and return the result line's dict
    (the caller prints it).  ``bench`` says which metrics the cell
    reports."""
    import torch

    cuda = torch.device(device).type == "cuda"
    marks = [("start", t_start)]
    weights = model.draw_weights(cfg, seed, device)
    mdl = model.build_model(cfg, weights, device)
    _sync(device)
    marks.append(("weights and model", time.perf_counter()))
    sub = (SubWindow(cell["trace"]["start_frac"] * seconds,
                     cell["trace"]["steps"], cuda) if trace else None)
    engine = warm_up(mdl, cfg, seed, sub)
    marks.append(("warm-up and fit", time.perf_counter()))
    judge_tail = cell["judge"] == "tail"
    base = None

    def opened(at):   # the window opens after the pre-roll
        nonlocal base
        base = at

    with spans.recording(trace) as recorded:
        reqs, steps, end, engine_reqs, at_close = window(
            cell, engine, mix, cfg, seed=seed, seconds=seconds, sub=sub,
            device=device, opened=opened)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n_bad = mismatches(reqs, engine_reqs)
    del engine, mdl
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    marks.append(("window and drain", time.perf_counter()))
    run = Run(cell=cell, config=cfg, window_s=seconds, end_s=end,
              setup_s=base - t_start, reqs=reqs, steps=steps,
              trace=sub.summary() if sub is not None else None,
              traced_from=sub.opened_at if sub is not None else None,
              spans=(None if recorded is None
                     else spans.window_spans(recorded, base)))
    if run.spans is not None:
        unpaired = spans.attach(steps, run.spans)
        if unpaired:
            print(f"spans: no step gets its spans' readings: "
                  f"{unpaired}", file=log)
    if run.trace is not None:
        print(f"trace: sub-window {run.trace['window_s']:.6f} s on the "
              f"trace's clock, {run.trace['wall_s']:.6f} s on the host's; "
              f"{run.trace['outside_s']:.6f} s of device time stamped "
              f"outside its marker; a device operation stamped up to "
              f"{run.trace['early_s']:.6f} s before its launch", file=log)
    marks.append(("trace read", time.perf_counter()))
    ok, compared, n_cmp = check.judge(weights, cfg, cell, reqs, n_bad,
                                      seed, device)
    marks.append(("check", time.perf_counter()))
    print("seconds: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:]))
        + (f"; profiler stop {sub.stop_cost_s:.3f}" if sub else ""),
        file=log)
    due = run.due_in_window()
    if judge_tail:
        attempted = len(due)
        failed = sum(not r.finished for r in due)
    else:
        attempted = sum(r.began is not None and 0 <= r.began < seconds
                        for r in reqs)
        failed = 0
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in catalog.cell_metrics(bench, cell["name"], group):
        v = catalog.reader(m["name"])(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = breakdown(run.trace)
    for c in compared.values():
        if not math.isfinite(c["value"]):
            c["value"] = None   # no number: JSON has no infinity
    result["compared"] = compared
    _report(run, at_close, n_cmp, log)
    return result


def _report(run: Run, at_close: dict, n_cmp: int, log) -> None:
    late = [r.submitted - r.due for r in run.reqs if r.submitted is not None]
    print(f"generator: {len(late)} submitted, late by at most "
          f"{max(late, default=0.0):.6f} s (p99 "
          f"{slo.percentile(late, 99):.6f} s)", file=log)
    print(f"at the window's close: {json.dumps(at_close)}; loop stopped at "
          f"{run.end_s:.3f} s", file=log)
    due = run.due_in_window()
    by_task = {}
    for r in due:
        by_task.setdefault(r.task, []).append(r)
    ttfts = [slo.ttft(r, run.end_s) for r in due]
    print(f"TTFT over the {len(due)} requests due in the window: p50 "
          f"{slo.percentile(ttfts, 50):.4f} s, p90 "
          f"{slo.percentile(ttfts, 90):.4f} s (not bounded: too noisy)",
          file=log)
    print("due in the window: " + json.dumps({
        t: {"n": len(rs), "finished": sum(r.finished for r in rs),
            "attained": slo.attainment(rs)} for t, rs in by_task.items()}),
        file=log)
    kinds = {}
    for s in run.steps:
        kinds[s.kind] = kinds.get(s.kind, 0) + 1
    print(f"steps by kind: {json.dumps(kinds)}; served tokens compared: "
          f"{n_cmp}", file=log)


def forbidden_modules() -> set[str]:
    return {m.split(".")[0] for m in sys.modules} & FORBIDDEN


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    root = catalog.ROOT.parent
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(root / "build" / "hfxbench" / sub)
    import repro_torch  # noqa: F401  (the program: no run without it)
    import torch

    bench = catalog.load_benchmark(root)
    chips = catalog.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hfxbench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()} (no CPU fallback)",
              file=sys.stderr)
        return 2
    cell, cfg, mix = catalog.resolve(args.workload)
    result = run_cell(cell, cfg, mix, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda:0",
                      t_start=t_start, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"hfxbench: loaded {sorted(found)}, which the benchmark must "
              f"not load", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0
