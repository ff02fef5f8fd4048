"""The traffic generator and the latency arithmetic."""

import math

import numpy as np
import pytest

from hfxbench import catalog, slo, traffic
from hfxbench.traffic import Req

MIXES = ["four_task", "two_task_overload"]


def _sched(mix, seed, rate=2.0, window=50.0, **kw):
    return traffic.schedule(mix, rate=rate, window_s=window, seed=seed,
                            vocab=151936, **kw)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = catalog.load_json("traffic", name)
    a, b = _sched(mix, 2 ** 31 + 11), _sched(mix, 2 ** 31 + 11)
    assert [(r.due, r.task, r.l_in, r.l_out) for r in a] == \
        [(r.due, r.task, r.l_in, r.l_out) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_work_and_the_arrivals(name):
    """Every seed: the same arrival times and task sequence, the same
    multiset of lengths per task, other prompts and another order."""
    mix = catalog.load_json("traffic", name)
    a, b = _sched(mix, 1), _sched(mix, 2)
    assert [(r.due, r.task) for r in a] == [(r.due, r.task) for r in b]
    for t in {r.task for r in a}:
        assert sorted(r.l_in for r in a if r.task == t) == \
            sorted(r.l_in for r in b if r.task == t)
        assert sorted(r.l_out for r in a if r.task == t) == \
            sorted(r.l_out for r in b if r.task == t)
    assert [r.l_in for r in a] != [r.l_in for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)


@pytest.mark.parametrize("name", MIXES)
def test_table1_means_and_rate(name):
    """Over many requests the draws give Table 1's means (before the
    clips, which only the long tails meet) and the rate."""
    mix = catalog.load_json("traffic", name)
    mix = {**mix, "max_prompt": 10 ** 6, "max_total": 10 ** 7}
    reqs = _sched(mix, 5, rate=4.0, window=1000.0)
    assert len(reqs) == 4000
    assert reqs[-1].due < 1000.0 and np.all(np.diff([r.due for r in reqs]) > 0)
    gaps = np.diff([0.0] + [r.due for r in reqs])
    assert gaps.mean() == pytest.approx(0.25, rel=0.01)
    assert gaps.std() == pytest.approx(0.25, rel=0.05)   # exponential
    for t in mix["tasks"]:
        mine = [r for r in reqs if r.task == t["name"]]
        assert len(mine) == 4000 // len(mix["tasks"])
        assert mine[0].ttft_slo == t["ttft_slo_s"]
        assert mine[0].tpot_slo == t["tpot_slo_s"]
        for key, attr in (("input", "l_in"), ("output", "l_out")):
            vals = np.array([getattr(r, attr) for r in mine])
            # the port's TaskSpec.sample_lengths, drawn at random
            draws = np.random.default_rng(0).normal(
                t[key]["mean"], t[key]["std"], 200_000)
            want = np.maximum(1, np.trunc(draws)).mean()
            assert vals.mean() == pytest.approx(want, rel=0.02)
            assert vals.std() == pytest.approx(
                np.maximum(1, np.trunc(draws)).std(), rel=0.05)


def test_clips_and_preroll():
    mix = catalog.load_json("traffic", "two_task_overload")
    reqs = _sched(mix, 3, rate=0.8, preroll_s=10.0, preroll_burst=10)
    pre = [r for r in reqs if r.due < 0]
    assert len(pre) == 18 and sum(r.due == -10.0 for r in pre) == 10
    assert len(reqs) - len(pre) == 40
    assert [r.rid for r in reqs] == list(range(len(reqs)))
    for r in reqs:
        assert 1 <= r.l_in <= 1536 and 1 <= r.l_out
        assert r.l_in + r.l_out <= 2047 and len(r.prompt) == r.l_in


def _req(due, first, last, n, l_out, ttft_slo=1.0, tpot_slo=0.5):
    r = Req(rid=0, task="t", due=due, l_in=4, l_out=l_out,
            ttft_slo=ttft_slo, tpot_slo=tpot_slo,
            prompt=np.zeros(4, np.int32), first=first, last=last)
    r.tokens = list(range(n))
    return r


def test_tails_and_attainment_count_the_unfinished():
    done = [_req(0.0, 0.5, 0.5 + 0.1 * 9, 10, 10) for _ in range(7)]
    slow = _req(1.0, 3.0, 3.0 + 0.8 * 4, 5, 5)          # TTFT 2 s, TPOT 0.8
    single = _req(2.0, 2.2, 2.2, 1, 1)                   # one token: TPOT 0
    waiting = _req(4.0, None, None, 0, 8)                # no token by the end
    partial = _req(5.0, 5.5, 6.0, 3, 9)                  # not finished
    reqs = done + [slow, single, waiting, partial]
    end = 10.0
    ttfts = [slo.ttft(r, end) for r in reqs]
    assert ttfts[-2] == pytest.approx(6.0) and ttfts[-1] == pytest.approx(0.5)
    assert slo.percentile(ttfts, 90) == pytest.approx(
        float(np.percentile(ttfts, 90)))
    assert slo.tpot(slow) == pytest.approx(0.8)
    assert slo.tpot(single) == 0.0
    assert slo.tpot(partial) is None and slo.tpot(waiting) is None
    # met: the 7 quick ones and the single token; missed: slow (both
    # limits), waiting and partial (never finished)
    assert slo.attainment(reqs) == pytest.approx(8 / 11)
    assert math.isnan(slo.percentile([], 90))
