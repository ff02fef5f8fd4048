"""The one traffic generator: an open-loop arrival schedule from a mix's
parameters, a rate and a seed.

A mix (``traffic/<mix>.json``) lists task classes, each with its share,
its TTFT and TPOT SLOs and normal prompt and output lengths (mean, std),
as Table 1 of the HFX paper gives them, and the clips that keep every
request inside the engine's positions.  The arithmetic is that of the
port's ``poisson_workload`` and ``TaskSpec.sample_lengths``: Poisson
arrivals with the tasks in equal shares, lengths ``max(1, int(normal))``.

The draws are stratified, so that every seed measures the same load:
the arrival times and the task of each arrival are one fixed draw of
the rate's Poisson process (the exponential's quantiles at
``(i + 0.5) / n`` as gaps, and the tasks by their shares, each in an
order drawn once and kept for every seed); every seed gets the same
multiset of lengths for each task (the normal's quantiles), in its own
seeded order, and its own prompt tokens.  A seed then changes which of
a task's requests comes when, but not the amount of work, the bursts or
the sequence of tasks: on a mix whose Eq. 5 interleave depends on which
tasks meet, a seed that reordered the tasks changed the tails by more
than two runs of one seed differ.
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Req:
    """One request of the schedule and what the open loop saw of it
    (times in seconds from the window's opening, on the host's clock)."""

    rid: int
    task: str
    due: float
    l_in: int
    l_out: int
    ttft_slo: float
    tpot_slo: float
    prompt: np.ndarray
    submitted: Optional[float] = None
    began: Optional[float] = None    # start of the step of its first chunk
    first: Optional[float] = None    # return of the step of its first token
    last: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.l_out


# the one draw of arrival times and tasks that every seed shares
ARRIVALS_SEED = 0


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, stream])


def _gaps(n: int, rate: float, span: float, rng) -> np.ndarray:
    """n inter-arrival gaps: the Exp(rate) quantiles, scaled to sum to
    ``span`` less half a mean gap, in a seeded order."""
    if n == 0:
        return np.zeros(0)
    q = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    q *= (span - 0.5 * span / n) / q.sum()
    return rng.permutation(q)


def _labels(n: int, tasks: list[dict], rng) -> list[int]:
    """Task index of each of n requests: counts by the largest remainder
    of the shares, in a seeded order."""
    shares = np.array([t["share"] for t in tasks], float)
    exact = n * shares / shares.sum()
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return list(rng.permutation(np.repeat(np.arange(len(tasks)), counts)))


def _lengths(n: int, dist: dict, rng) -> np.ndarray:
    z = [NormalDist().inv_cdf((j + 0.5) / n) for j in range(n)]
    vals = [max(1, int(dist["mean"] + dist["std"] * zj)) for zj in z]
    return rng.permutation(np.array(vals, np.int64))


def _requests(n: int, dues: np.ndarray, mix: dict, fixed, rng, vocab: int,
              rid0: int) -> list[Req]:
    """n requests due at ``dues``: tasks from the ``fixed`` generator,
    lengths and prompts from the seed's ``rng``."""
    tasks = mix["tasks"]
    labels = _labels(n, tasks, fixed)
    lens = {}
    for k, t in enumerate(tasks):
        m = labels.count(k)
        lens[k] = (list(_lengths(m, t["input"], rng)),
                   list(_lengths(m, t["output"], rng)))
    out = []
    for i, (due, k) in enumerate(zip(dues, labels)):
        t = tasks[k]
        l_in = min(int(lens[k][0].pop()), mix["max_prompt"])
        l_out = min(int(lens[k][1].pop()), mix["max_total"] - l_in)
        prompt = rng.integers(0, vocab, l_in, dtype=np.int64).astype(np.int32)
        out.append(Req(rid=rid0 + i, task=t["name"], due=float(due),
                       l_in=l_in, l_out=l_out, ttft_slo=t["ttft_slo_s"],
                       tpot_slo=t["tpot_slo_s"], prompt=prompt))
    return out


def schedule(mix: dict, *, rate: float, window_s: float, seed: int,
             vocab: int, preroll_s: float = 0.0,
             preroll_burst: int = 0) -> list[Req]:
    """The requests due from ``-preroll_s`` to ``window_s``, by due time.

    The window holds ``round(rate * window_s)`` requests, due within
    ``(0, window_s)``; a pre-roll adds ``preroll_burst`` requests due at
    ``-preroll_s`` and ``round(rate * preroll_s)`` more due within
    ``(-preroll_s, 0)``, drawn apart so that the window's multiset does
    not depend on the pre-roll."""
    if mix.get("arrival") != "poisson":
        raise ValueError(f"unknown arrival process {mix.get('arrival')!r}")
    out: list[Req] = []
    if preroll_s > 0:
        n_pre = int(round(rate * preroll_s))
        fixed = rng_for(ARRIVALS_SEED, 2)
        gaps = _gaps(n_pre, rate, preroll_s, fixed)
        dues = np.concatenate([np.full(preroll_burst, -preroll_s),
                               -preroll_s + np.cumsum(gaps)])
        out += _requests(len(dues), dues, mix, fixed, rng_for(seed, 2),
                         vocab, rid0=0)
    n = int(round(rate * window_s))
    fixed = rng_for(ARRIVALS_SEED, 1)
    dues = np.cumsum(_gaps(n, rate, window_s, fixed))
    out += _requests(n, dues, mix, fixed, rng_for(seed, 1), vocab,
                     rid0=len(out))
    return out

