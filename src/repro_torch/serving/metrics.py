"""Evaluation metrics (paper §7.5): attainment, E2E latency, cost.

A copy of the post-run summary of ``repro/serving/metrics.py``:
:func:`compute_metrics` reduces finished request records to a
:class:`RunMetrics` with the same schema as the JAX package, per-task
TTFT/TPOT attainment included.  The streaming counters are not copied:
the online session API is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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
