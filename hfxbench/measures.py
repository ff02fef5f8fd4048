"""The arithmetic behind the metric readers (``metrics/<name>.py``).

End-to-end numbers are taken over the window as the client saw it;
step numbers over the steps that began in the window before the
profiled sub-window (the profiler slows its steps, and ending it stalls
the loop); device numbers over the profiled sub-window alone.  Shares
are in percent.  A reader that finds nothing to read returns None and
the metric is left out.
"""

from __future__ import annotations

from hfxbench import roofline, slo

# the paged decode attention call's device functions (the group kernel
# and its merge; the split kernel is the f32 / other-width route)
PAGED_DECODE_KERNELS = ("paged_group_kernel", "decode_merge_kernel",
                        "paged_decode_attention_split_kernel")


def ttft_tail(run, q: float):
    """The q-th percentile of TTFT over every request due in the window."""
    due = run.due_in_window()
    return slo.percentile([slo.ttft(r, run.end_s) for r in due], q) \
        if due else None


def tpot_tail(run, q: float):
    """The q-th percentile of TPOT over the window's finished requests
    of two tokens or more."""
    vals = [slo.tpot(r) for r in run.due_in_window()
            if r.finished and len(r.tokens) > 1]
    return slo.percentile(vals, q) if vals else None


def slo_attainment(run):
    due = run.due_in_window()
    return 100.0 * slo.attainment(due) if due else None


def output_tok_s(run):
    n = sum(s.emitted for s in run.steps if 0.0 <= s.t1 < run.window_s)
    return n / run.window_s


def _mean(vals):
    return sum(vals) / len(vals) if vals else None


def prefill_tokens_per_step(run):
    return _mean([s.tokens for s in run.window_steps("prefill_chunk")])


def decode_k_mean(run):
    return _mean([s.k for s in run.window_steps("decode")])


def prefill_ms(run):
    return _mean([1e3 * s.span for s in run.window_steps("prefill_chunk")])


def decode_iter_ms(run):
    steps = run.window_steps("decode")
    iters = sum(s.k for s in steps)
    return 1e3 * sum(s.span for s in steps) / iters if iters else None


def _prefill_bound(counts, s) -> tuple[float, float]:
    """(FLOPs, least seconds) of a prefill step's real work."""
    flops = counts.prefill_flops(s.rows, s.n_completed)
    return flops, roofline.bound_s(flops, counts.prefill_bytes(s.rows))


def _decode_bound(counts, s) -> float:
    return sum(roofline.bound_s(counts.decode_iter_flops(emit),
                                counts.decode_iter_bytes(emit))
               for emit, _ in s.decode_iters() if emit)


def mfu_prefill(run):
    steps = run.window_steps("prefill_chunk")
    span = sum(s.span for s in steps)
    if not span:
        return None
    flops = sum(_prefill_bound(run.counts, s)[0] for s in steps)
    return 100.0 * flops / (roofline.H100_BF16_FLOPS * span)


def mfu_decode(run):
    steps = run.window_steps("decode")
    span = sum(s.span for s in steps)
    return (100.0 * sum(_decode_bound(run.counts, s) for s in steps) / span
            if span else None)


def mfu_window(run):
    counts = run.counts
    least = 0.0
    for s in run.window_steps():
        if s.kind == "decode":
            least += _decode_bound(counts, s)
        elif s.kind == "prefill_chunk":
            least += _prefill_bound(counts, s)[1]
    return 100.0 * least / run.span_s if run.span_s > 0 else None


def paged_decode_roofline(run):
    """The paged decode attention calls of the profiled decode steps:
    their least time (each call of an iteration as the family counts
    it: bytes of the K and V each row's length covers, of q and out)
    over the summed device time of the call's functions."""
    if run.trace is None:
        return None
    counts = run.counts
    least = 0.0
    for s in run.traced_steps("decode"):
        for _, read in s.decode_iters():
            least += sum(roofline.bound_s(flops, nbytes)
                         for flops, nbytes in counts.paged_decode_calls(read))
    device = sum(v["s"] for name, v in run.trace["kernels"].items()
                 if any(k in name for k in PAGED_DECODE_KERNELS))
    return 100.0 * least / device if least and device else None


def idle_share(run):
    """None where the trace holds no device operation (a CPU run)."""
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
