"""Evaluation metrics (paper §7.5): attainment, E2E latency, cost.

Two views over the same request records:

- :func:`compute_metrics` — the closed-world post-run summary
  (:class:`RunMetrics`), identical schema for simulator and engine
  runs.
- Streaming/incremental — :meth:`RunMetrics.partial` computes a
  *rolling* snapshot mid-run (attainment over finished-so-far, not a
  denominator that counts still-in-flight work as misses), and
  :class:`StreamingStats` accumulates per-event figures the batch
  summary can't see (TTFB from the event stream, inter-token latency,
  admit/reject counters) without ever scanning the request list.

A copy of ``repro/serving/metrics.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.request import Request, RequestState

COST_UNIT = 0.05  # one unit = one instance active for 50 ms


@dataclasses.dataclass
class RunMetrics:
    attainment: float
    ttft_attainment: float
    tpot_attainment: float
    mean_e2e: float
    p99_e2e: float
    mean_ttft: float
    cost_units: float
    makespan: float
    n_finished: int
    n_total: int
    per_task: dict
    # refused at submit time by admission control (online sessions);
    # rejected requests count in n_total and against attainment
    n_rejected: int = 0
    # lost to a fault (replica crash / unrecoverable transfer) after
    # admission; like rejected, they count in n_total and against
    # attainment — a shed request IS the degradation the fault caused
    n_failed: int = 0
    # prefix cache: prompt tokens served from cached KV pages instead
    # of prefilled, and the hit fraction over all offered prompt tokens
    # (non-rejected requests).  Zero when the cache is off — the schema
    # is identical either way, and on both planes.
    prefix_hit_tokens: int = 0
    prefix_hit_rate: float = 0.0
    # requests that experienced >= 1 landed KV migration (P/D hand-off
    # or live decode-to-decode) and total landed moves — zero without
    # migration, same schema on both planes
    n_migrated: int = 0
    n_kv_moves: int = 0

    def row(self) -> dict:
        """Canonical flat/JSON payload — identical schema for simulator
        and engine-backed runs, including the per-task SLO-attainment
        breakdown (TTFT and TPOT separately), so multi-SLO claims are
        inspectable per task class."""
        return {
            "attainment": round(self.attainment, 4),
            "ttft_attainment": round(self.ttft_attainment, 4),
            "tpot_attainment": round(self.tpot_attainment, 4),
            "mean_e2e": round(self.mean_e2e, 3),
            "p99_e2e": round(self.p99_e2e, 3),
            "mean_ttft": round(self.mean_ttft, 4),
            "cost_units": round(self.cost_units, 1),
            "makespan": round(self.makespan, 2),
            "n_finished": self.n_finished,
            "n_total": self.n_total,
            "n_rejected": self.n_rejected,
            "n_failed": self.n_failed,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": round(self.prefix_hit_rate, 4),
            "n_migrated": self.n_migrated,
            "n_kv_moves": self.n_kv_moves,
            "per_task": {
                t: {k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in stats.items()}
                for t, stats in self.per_task.items()
            },
        }

    @classmethod
    def partial(cls, requests: Sequence[Request], cost_units: float,
                now: float) -> "RunMetrics":
        """Rolling mid-run snapshot: attainment rates are over the
        requests *finished so far* (an in-flight request is not yet a
        miss), while ``n_total`` / ``n_rejected`` still report the full
        offered load.  ``makespan`` is the current clock."""
        fin = [r for r in requests if r.finish_time is not None]
        m = compute_metrics(fin, cost_units, now)
        m.n_total = len(requests)
        m.n_rejected = sum(
            1 for r in requests if r.state == RequestState.REJECTED
        )
        m.n_failed = sum(
            1 for r in requests if r.state == RequestState.FAILED
        )
        return m


def compute_metrics(requests: Sequence[Request], cost_units: float,
                    makespan: float) -> RunMetrics:
    fin = [r for r in requests if r.finish_time is not None]
    n = len(requests)
    att = sum(1 for r in fin if r.attained()) / max(n, 1)
    ttft_att = sum(1 for r in fin if r.ttft_ok()) / max(n, 1)
    tpot_att = sum(1 for r in fin if r.tpot_ok()) / max(n, 1)
    e2e = np.array([r.e2e for r in fin]) if fin else np.array([0.0])
    ttfts = np.array([r.ttft for r in fin]) if fin else np.array([0.0])
    per_task: dict[str, dict] = {}
    tasks = sorted({r.task for r in requests})
    for t in tasks:
        tf = [r for r in fin if r.task == t]
        tn = sum(1 for r in requests if r.task == t)
        per_task[t] = {
            "attainment": sum(1 for r in tf if r.attained()) / max(tn, 1),
            "ttft_attainment": sum(
                1 for r in tf if r.ttft_ok()) / max(tn, 1),
            "tpot_attainment": sum(
                1 for r in tf if r.tpot_ok()) / max(tn, 1),
            "mean_e2e": float(np.mean([r.e2e for r in tf])) if tf else 0.0,
            "mean_ttft": float(np.mean([r.ttft for r in tf])) if tf else 0.0,
            "n": tn,
            "n_finished": len(tf),
        }
    served = [r for r in requests if r.state != RequestState.REJECTED]
    hit_tok = sum(r.prefix_hit_tokens for r in served)
    offered_tok = sum(r.l_in for r in served)
    return RunMetrics(
        attainment=att,
        ttft_attainment=ttft_att,
        tpot_attainment=tpot_att,
        mean_e2e=float(np.mean(e2e)),
        p99_e2e=float(np.percentile(e2e, 99)),
        mean_ttft=float(np.mean(ttfts)),
        cost_units=cost_units,
        makespan=makespan,
        n_finished=len(fin),
        n_total=n,
        per_task=per_task,
        n_rejected=sum(
            1 for r in requests if r.state == RequestState.REJECTED
        ),
        n_failed=sum(
            1 for r in requests if r.state == RequestState.FAILED
        ),
        prefix_hit_tokens=int(hit_tok),
        prefix_hit_rate=hit_tok / max(offered_tok, 1),
        n_migrated=sum(1 for r in requests if r.n_migrations > 0),
        n_kv_moves=sum(r.n_migrations for r in requests),
    )


class StreamingStats:
    """Incremental accounting over a live stream of serving events.

    Fed one event at a time by :class:`~repro_torch.serving.session.
    ServingSession` (kinds: ``admitted`` / ``rejected`` /
    ``first_token`` / ``token`` / ``finished``).  Tracks what the
    post-run summary cannot: TTFB as the client observed it on the
    stream, inter-token latencies (per handle, from consecutive token
    stamps), and the admission split.  O(1) per event.
    """

    # latency samples are ring-capped so a long-lived session's
    # footprint stays bounded; percentiles then cover the most recent
    # window, which is what a live dashboard wants anyway
    MAX_SAMPLES = 65536

    def __init__(self):
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_finished = 0
        self.n_failed = 0
        self.n_retried = 0
        self.n_tokens = 0
        self._ttfb: list[float] = []
        self._itl: list[float] = []
        self._ttfb_i = 0
        self._itl_i = 0
        self._last_tok: dict[int, float] = {}  # rid -> last token stamp

    def _push(self, buf: list, cursor: int, x: float) -> int:
        if len(buf) < self.MAX_SAMPLES:
            buf.append(x)
            return cursor
        buf[cursor] = x
        return (cursor + 1) % self.MAX_SAMPLES

    def observe(self, kind: str, rid: int, t: float,
                arrival: Optional[float] = None) -> None:
        if kind == "admitted":
            self.n_admitted += 1
        elif kind == "rejected":
            self.n_rejected += 1
        elif kind == "first_token":
            self.n_tokens += 1
            if arrival is not None:
                self._ttfb_i = self._push(self._ttfb, self._ttfb_i,
                                          t - arrival)
            self._last_tok[rid] = t
        elif kind == "token":
            self.n_tokens += 1
            last = self._last_tok.get(rid)
            if last is not None:
                self._itl_i = self._push(self._itl, self._itl_i,
                                         t - last)
            self._last_tok[rid] = t
        elif kind == "finished":
            self.n_finished += 1
            self._last_tok.pop(rid, None)
        elif kind == "failed":
            self.n_failed += 1
            self._last_tok.pop(rid, None)
        elif kind == "retried":
            self.n_retried += 1
            # a crash re-prefill re-emits from scratch: the next token
            # stamp must not be compared to a pre-fault one (the gap is
            # recovery latency, not steady-state inter-token latency)
            self._last_tok.pop(rid, None)

    @staticmethod
    def _pct(xs: list, q: float) -> float:
        return float(np.percentile(np.array(xs), q)) if xs else 0.0

    def row(self) -> dict:
        """Flat JSON payload (the BENCH_streaming.json schema)."""
        return {
            "n_admitted": self.n_admitted,
            "n_rejected": self.n_rejected,
            "n_finished": self.n_finished,
            "n_failed": self.n_failed,
            "n_retried": self.n_retried,
            "n_tokens": self.n_tokens,
            "mean_ttfb": round(float(np.mean(self._ttfb))
                               if self._ttfb else 0.0, 5),
            "p99_ttfb": round(self._pct(self._ttfb, 99), 5),
            "mean_itl": round(float(np.mean(self._itl))
                              if self._itl else 0.0, 6),
            "p99_itl": round(self._pct(self._itl, 99), 6),
        }
