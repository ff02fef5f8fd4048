"""Workload generation (paper §7.3).

Poisson inter-arrivals per task, equal share per task, fixed seed; plus
the Fig. 6 dynamic ramp (priority classes joining every 20 s).

Request ids are assigned exactly once, AFTER arrival-sorting, so
``rid`` always equals the request's arrival rank and callers never see
an id change under them.

``materialize_prompts`` turns a length-only workload into an
engine-plane workload by synthesizing deterministic token ids, so the
same generators feed both the simulator and the real JAX engine.

A copy of ``repro/serving/workload.py``, its code kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.request import FOUR_TASK_SET, TASKS, TWO_TASK_SET, Request, TaskSpec


def _finalize(reqs: list[Request]) -> list[Request]:
    """Arrival-sort, then assign rids (the only assignment ever made)."""
    reqs.sort(key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def poisson_workload(task_names: Sequence[str], qps: float,
                     n_per_task: int = 300, seed: int = 0,
                     use_priority: bool = False) -> list[Request]:
    """Total rate `qps`, split equally across tasks; n_per_task samples."""
    rng = np.random.default_rng(seed)
    per_task_rate = qps / len(task_names)
    reqs: list[Request] = []
    for name in task_names:
        spec = TASKS[name]
        t = 0.0
        for _ in range(n_per_task):
            t += rng.exponential(1.0 / per_task_rate)
            l_in, l_out = spec.sample_lengths(rng)
            reqs.append(Request(
                rid=-1, task=name, arrival=t, l_in=l_in, l_out=l_out,
                ttft_slo=spec.ttft_slo, tpot_slo=spec.tpot_slo,
                priority=spec.priority if use_priority else None,
            ))
    return _finalize(reqs)


def ramp_workload(task_names: Sequence[str], qps_per_class: float = 15.0,
                  join_every: float = 20.0, duration: float = 100.0,
                  n_per_class: Optional[int] = None,
                  seed: int = 0) -> list[Request]:
    """Fig. 6 dynamic ramp: the lowest-priority class starts first and
    every `join_every` seconds the next (higher) class joins; all active
    classes keep arriving until `duration` (total rate ramps up)."""
    rng = np.random.default_rng(seed)
    specs = sorted((TASKS[n] for n in task_names),
                   key=lambda s: -s.priority)  # lowest priority first
    reqs: list[Request] = []
    for k, spec in enumerate(specs):
        t = k * join_every
        n_class = 0
        while t < duration:
            t += rng.exponential(1.0 / qps_per_class)
            if t >= duration:
                break
            if n_per_class and n_class >= n_per_class:
                break
            l_in, l_out = spec.sample_lengths(rng)
            reqs.append(Request(
                rid=-1, task=spec.name, arrival=t, l_in=l_in, l_out=l_out,
                ttft_slo=spec.ttft_slo, tpot_slo=spec.tpot_slo,
                priority=spec.priority,
            ))
            n_class += 1
    return _finalize(reqs)


def single_task_workload(task: str = "wikisql", qps: float = 10.0,
                         n: int = 300, seed: int = 0,
                         ttft: float = 0.7, tpot: float = 0.5):
    """Fig. 7 single-task setting with overridden SLOs."""
    rng = np.random.default_rng(seed)
    spec = TASKS[task]
    reqs = []
    t = 0.0
    for rid in range(n):
        t += rng.exponential(1.0 / qps)
        l_in, l_out = spec.sample_lengths(rng)
        reqs.append(Request(
            rid=rid, task=task, arrival=t, l_in=l_in, l_out=l_out,
            ttft_slo=ttft, tpot_slo=tpot,
        ))
    return reqs


def engine_smoke_workload(task: str = "gsm8k", n: int = 8,
                          qps: float = 24.0, seed: int = 3,
                          clip_in: int = 24,
                          clip_out: int = 6) -> list[Request]:
    """A Table-1 workload sized to the reduced CPU engine: Poisson
    arrivals with prompt/output lengths clipped so every request fits
    ``EngineConfig.smoke()``.  Shared by the engine-plane example,
    benchmark, and CI smoke runs so their setups can't diverge."""
    reqs = poisson_workload([task], qps=qps, n_per_task=n, seed=seed)
    for r in reqs:
        r.l_in = min(r.l_in, clip_in)
        r.l_out = min(r.l_out, clip_out)
    return reqs


def shared_prefix_workload(task: str = "gsm8k", n: int = 64,
                           qps: float = 8.0, seed: int = 0, *,
                           n_groups: int = 8, zipf_a: float = 1.1,
                           shape: str = "chat", prefix_len: int = 128,
                           suffix_len: int = 32, turn_growth: int = 64,
                           max_turns: int = 8,
                           l_out: Optional[int] = None) -> list[Request]:
    """Zipfian shared-prefix workload (the prefix-cache stressor).

    Each request joins one of ``n_groups`` prefix groups, drawn with
    probability proportional to 1/k^zipf_a (group 1 hottest) — a few
    system prompts dominate, matching observed chat traffic.  Two
    shapes:

    - ``"chat"``: every group-k request shares the same ``prefix_len``
      system prompt and appends a private suffix of 1..``suffix_len``
      tokens.
    - ``"agent"``: groups are agent *sessions* whose shared history
      grows by ``turn_growth`` tokens per turn (capped at
      ``max_turns``), so later requests re-prefill an ever-longer
      prefix unless a cache holds it.

    SLOs come from ``TASKS[task]``; ``l_out`` overrides the task's
    sampled output length (benchmarks want short, fixed decodes).
    ``prefix_group``/``prefix_len`` carry the sharing structure to both
    planes: the simulator keys its prefix index on them, the engine
    materializes matching token ids from them.
    """
    if shape not in ("chat", "agent"):
        raise ValueError(f"unknown shape {shape!r} (chat|agent)")
    if n_groups < 1:
        raise ValueError("n_groups must be >= 1")
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, n_groups + 1, dtype=np.float64) ** zipf_a
    weights /= weights.sum()
    spec = TASKS[task]
    turns: dict[int, int] = {}
    reqs: list[Request] = []
    t = 0.0
    for _ in range(n):
        t += rng.exponential(1.0 / qps)
        g = int(rng.choice(n_groups, p=weights))
        if shape == "chat":
            plen = prefix_len
        else:
            turn = min(turns.get(g, 0), max_turns - 1)
            turns[g] = turns.get(g, 0) + 1
            plen = prefix_len + turn * turn_growth
        sfx = int(rng.integers(1, suffix_len + 1))
        if l_out is not None:
            lo = int(l_out)
        else:
            lo = max(1, int(rng.normal(spec.out_mean, spec.out_std)))
        reqs.append(Request(
            rid=-1, task=task, arrival=t, l_in=plen + sfx, l_out=lo,
            ttft_slo=spec.ttft_slo, tpot_slo=spec.tpot_slo,
            prefix_group=g, prefix_len=plen,
        ))
    return _finalize(reqs)


# group-prefix token streams are generated in fixed-size chunks so a
# group's length-L prefix is always a strict prefix of its length-L'
# stream (L < L') — agent sessions grow their history without ever
# rewriting earlier tokens, which is what makes page keys stable
_PREFIX_CHUNK = 256


def _group_prefix_tokens(vocab_size: int, seed: int, group: int,
                         length: int) -> np.ndarray:
    """Deterministic token stream for one prefix group, independent of
    how much of it any particular request consumes."""
    chunks = []
    got, ci = 0, 0
    while got < length:
        chunk_rng = np.random.default_rng([seed, 0x5EED, int(group), ci])
        chunks.append(chunk_rng.integers(0, vocab_size,
                                         size=_PREFIX_CHUNK))
        got += _PREFIX_CHUNK
        ci += 1
    return np.concatenate(chunks)[:length].astype(np.int32)


def materialize_prompts(requests: Sequence[Request], vocab_size: int,
                        seed: int = 0, max_len: Optional[int] = None,
                        rng: Optional[np.random.Generator] = None
                        ) -> Sequence[Request]:
    """Give length-only requests real token ids for the engine plane.

    Deterministic under `seed`; requests that already carry a prompt are
    left untouched.  With `max_len` set, validates that every prompt
    leaves room to generate (the engine would reject it mid-run
    otherwise, which is a much worse failure mode).  Pass a live `rng`
    to draw incrementally (ServingSession materializes per submit with
    one persistent generator, so an online replay is prompt-identical
    to a batch run that materialized the whole list up front)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    for r in requests:
        if r.prompt is None:
            if r.prefix_group is not None and r.prefix_len > 0:
                # shared-prefix request: the group span comes from the
                # group's deterministic stream (keyed by `seed`, NOT
                # the live rng — group-mates materialized in any order
                # get byte-identical prefixes), the private suffix from
                # the sequential rng like any other prompt
                plen = min(r.prefix_len, max(1, r.l_in))
                prefix = _group_prefix_tokens(
                    vocab_size, seed, r.prefix_group, plen
                )
                sfx = rng.integers(
                    0, vocab_size, size=max(1, r.l_in) - plen
                ).astype(np.int32)
                r.prompt = np.concatenate([prefix, sfx]).astype(np.int32)
            else:
                r.prompt = rng.integers(
                    0, vocab_size, size=max(1, r.l_in)
                ).astype(np.int32)
            r.l_in = int(len(r.prompt))
        if max_len is not None and len(r.prompt) >= max_len:
            raise ValueError(
                f"request {r.rid}: prompt of {len(r.prompt)} tokens "
                f"cannot generate within engine max_len={max_len}; size "
                f"the workload to the engine (or raise max_len)"
            )
    return requests
