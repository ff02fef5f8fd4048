"""Scheduling policies: HyperFlexis (Algorithm 1) + the paper's baselines.

Baselines (§7.4), re-implemented against the same worker/latency
abstractions so comparisons are apples-to-apples:

- ROUND ROBIN (Llumnix+RR in the paper): immediate cyclic assignment.
- SCORPIO-like: deadline(EDF)-ordered queue + admission control against
  the predicted prefill completion, with a per-dispatch token cap
  (credit-aware batching, simplified).
- ALADDIN-like: best-fit bin packing on the predicted token budget.
- SIMULATED ANNEALING (Huang et al.): periodic batch assignment via SA
  minimizing predicted SLO violations.

Every policy exposes on_request_arrive / dispatch_pass / next_wakeup /
add_worker / remove_worker, so the cluster loop is policy-agnostic.

A copy of ``repro/core/policies.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from repro_torch.core.dispatcher import (
    AdmissionVerdict,
    Dispatcher,
    DispatcherConfig,
)
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.monitor import Monitor
from repro_torch.core.request import Request


class BasePolicy:
    name = "base"

    def __init__(self, latency_model: LatencyModel, monitor: Monitor,
                 on_dispatch: Callable, load_calc=None):
        self.model = latency_model
        self.monitor = monitor
        self.on_dispatch = on_dispatch
        # optional shared InstanceLoadCalculator (HyperFlexis threads it
        # into the Dispatcher; baselines ignore it by design — they ARE
        # the no-load-signal comparison points)
        self.load_calc = load_calc
        self.workers: list = []
        self.queue: list[Request] = []

    def add_worker(self, worker, now: float) -> None:
        self.workers.append(worker)

    def remove_worker(self, wid: int) -> None:
        self.workers = [w for w in self.workers if w.wid != wid]

    def on_request_arrive(self, r: Request) -> None:
        self.queue.append(r)

    def pending(self) -> int:
        return len(self.queue)

    def queued_requests(self):
        return list(self.queue)

    def drop_request(self, r: Request) -> None:
        """Remove a still-queued request (fault recovery sheds work
        that lost its last possible placement).  No-op if absent."""
        if r in self.queue:
            self.queue.remove(r)

    def next_wakeup(self) -> Optional[float]:
        return None

    def notify_worker_free(self, wid: int, now: float) -> None:
        pass

    def admission_verdict(self, r: Request, now: float) -> AdmissionVerdict:
        """Submit-time admit/reject estimate.  Baselines carry no
        proactive budget estimator, so they admit everything — only
        HyperFlexis (Algorithm 1) can refuse a doomed request at the
        front door."""
        return AdmissionVerdict(True, 1.0,
                                reason="policy has no budget estimator")

    def dispatch_pass(self, now: float):  # pragma: no cover - interface
        raise NotImplementedError


class HyperFlexisPolicy(BasePolicy):
    """Algorithm 1 via the core Dispatcher."""

    name = "hyperflexis"

    def __init__(self, latency_model, monitor, on_dispatch,
                 cfg: Optional[DispatcherConfig] = None, load_calc=None):
        # cfg defaults to None, not DispatcherConfig(): a default built
        # in the signature is evaluated once at import and shared by
        # every policy instance (Dispatcher builds its own fresh one)
        super().__init__(latency_model, monitor, on_dispatch,
                         load_calc=load_calc)
        self.dispatcher = Dispatcher(
            latency_model, monitor, cfg, on_dispatch=on_dispatch,
            load_calc=load_calc,
        )

    def add_worker(self, worker, now: float) -> None:
        super().add_worker(worker, now)
        self.dispatcher.add_worker(worker, now)

    def remove_worker(self, wid: int) -> None:
        super().remove_worker(wid)
        self.dispatcher.remove_worker(wid)

    def on_request_arrive(self, r: Request) -> None:
        self.dispatcher.on_request_arrive(r)

    def pending(self) -> int:
        return self.dispatcher.pending()

    def queued_requests(self):
        return self.dispatcher.qr.items()

    def drop_request(self, r: Request) -> None:
        self.dispatcher.qr.remove(r)

    def next_wakeup(self):
        return self.dispatcher.next_wakeup()

    def notify_worker_free(self, wid: int, now: float) -> None:
        self.dispatcher.notify_worker_free(wid, now)

    def admission_verdict(self, r: Request, now: float) -> AdmissionVerdict:
        return self.dispatcher.admission_verdict(r, now)

    def dispatch_pass(self, now: float):
        return self.dispatcher.dispatch_pass(now)


class RoundRobinPolicy(BasePolicy):
    name = "rr"

    def __init__(self, latency_model, monitor, on_dispatch,
                 load_calc=None):
        super().__init__(latency_model, monitor, on_dispatch,
                         load_calc=load_calc)
        self._next = 0

    def dispatch_pass(self, now: float):
        done = []
        active = [w for w in self.workers if w.active]
        if not active:
            return done
        while self.queue:
            r = self.queue.pop(0)
            w = active[self._next % len(active)]
            self._next += 1
            r.dispatch_time = now
            self.on_dispatch(w, [r], now)
            done.append((w, [r]))
        return done


class ScorpioPolicy(BasePolicy):
    """EDF + admission control + token-capped batching (simplified)."""

    name = "scorpio"

    def __init__(self, latency_model, monitor, on_dispatch,
                 batch_token_cap: int = 8192, load_calc=None):
        super().__init__(latency_model, monitor, on_dispatch,
                         load_calc=load_calc)
        self.cap = batch_token_cap

    def dispatch_pass(self, now: float):
        done = []
        active = [w for w in self.workers if w.active]
        if not active:
            return done
        self.queue.sort(key=lambda r: r.deadline())
        remaining: list[Request] = []
        batches: dict[int, list[Request]] = {w.wid: [] for w in active}
        by_wid = {w.wid: w for w in active}
        for r in self.queue:
            best, best_t = None, None
            for w in active:
                lens = ([q.l_in for q in w.waiting]
                        + [q.l_in for q in batches[w.wid]] + [r.l_in])
                if sum(lens) > self.cap:
                    continue
                if w.kv_capacity - w.kv_tokens() < r.l_in:
                    continue
                t_done = max(now, w.busy_until) + self.model.prefill_time(
                    lens
                )
                if best_t is None or t_done < best_t:
                    best, best_t = w, t_done
            admit = (best is not None
                     and (best_t <= r.deadline() or r.deadline() <= now))
            if admit:
                batches[best.wid].append(r)
            else:
                remaining.append(r)
        self.queue = remaining
        for wid, batch in batches.items():
            if batch:
                for r in batch:
                    r.dispatch_time = now
                self.on_dispatch(by_wid[wid], batch, now)
                done.append((by_wid[wid], batch))
        return done


class AladdinPolicy(BasePolicy):
    """Joint placement: best-fit bin packing among workers whose
    predicted prefill completion still meets the request deadline."""

    name = "aladdin"

    def dispatch_pass(self, now: float):
        done = []
        active = [w for w in self.workers if w.active]
        if not active:
            return done
        pending = sorted(self.queue, key=lambda r: -r.l_in)  # FFD-style
        self.queue = []
        leftovers = []
        placed: dict[int, list[Request]] = {w.wid: [] for w in active}
        by_wid = {w.wid: w for w in active}
        head = {w.wid: w.kv_capacity - w.kv_tokens() for w in active}
        for r in pending:
            feasible = []
            fallback = []
            for w in active:
                if head[w.wid] < r.l_in:
                    continue
                lens = ([q.l_in for q in w.waiting]
                        + [q.l_in for q in placed[w.wid]] + [r.l_in])
                t_done = max(now, w.busy_until) + self.model.prefill_time(
                    lens
                )
                item = (head[w.wid] - r.l_in, t_done, w.wid)
                fallback.append((t_done, w.wid))
                if t_done <= r.deadline():
                    feasible.append(item)
            if feasible:
                _, _, wid = min(feasible)  # tightest feasible fit
            elif fallback:
                _, wid = min(fallback)     # earliest finish otherwise
            else:
                leftovers.append(r)
                continue
            placed[wid].append(r)
            head[wid] -= r.l_in
        self.queue = leftovers
        for wid, batch in placed.items():
            if batch:
                for r in batch:
                    r.dispatch_time = now
                self.on_dispatch(by_wid[wid], batch, now)
                done.append((by_wid[wid], batch))
        return done


class SAPolicy(BasePolicy):
    """Simulated-annealing batch scheduler (Huang et al., simplified)."""

    name = "sa"

    def __init__(self, latency_model, monitor, on_dispatch,
                 iters: int = 200, seed: int = 0, load_calc=None):
        super().__init__(latency_model, monitor, on_dispatch,
                         load_calc=load_calc)
        self.iters = iters
        self.rng = np.random.default_rng(seed)

    def _violations(self, assign, reqs, active, now) -> float:
        score = 0.0
        for wi, w in enumerate(active):
            batch = [r for r, a in zip(reqs, assign) if a == wi]
            if not batch:
                continue
            lens = [q.l_in for q in w.waiting] + [r.l_in for r in batch]
            t_done = max(now, w.busy_until) + self.model.prefill_time(lens)
            for r in batch:
                if t_done > r.deadline():
                    score += 1.0
            # decode pressure
            cur = [q.cur_len for q in w.running]
            e_d = self.model.decode_step_time(
                cur + [r.l_in for r in batch]
            )
            tpots = [q.tpot_slo for q in w.running] + [
                r.tpot_slo for r in batch
            ]
            if tpots and e_d > min(tpots):
                score += 0.5 * len(batch)
        return score

    def dispatch_pass(self, now: float):
        done = []
        active = [w for w in self.workers if w.active]
        if not active or not self.queue:
            return done
        reqs = self.queue[:64]
        self.queue = self.queue[64:]
        n, k = len(reqs), len(active)
        assign = self.rng.integers(0, k, size=n)
        best = assign.copy()
        best_score = self._violations(assign, reqs, active, now)
        temp = 1.0
        for _ in range(self.iters):
            cand = best.copy()
            cand[self.rng.integers(0, n)] = self.rng.integers(0, k)
            s = self._violations(cand, reqs, active, now)
            if (s < best_score
                    or self.rng.random() < math.exp(
                        -(s - best_score) / max(temp, 1e-3))):
                best, best_score = cand, s
            temp *= 0.98
        batches: dict[int, list[Request]] = {w.wid: [] for w in active}
        for r, a in zip(reqs, best):
            batches[active[a].wid].append(r)
        by_wid = {w.wid: w for w in active}
        for wid, batch in batches.items():
            if batch:
                for r in batch:
                    r.dispatch_time = now
                self.on_dispatch(by_wid[wid], batch, now)
                done.append((by_wid[wid], batch))
        return done


POLICIES = {
    "hyperflexis": HyperFlexisPolicy,
    "rr": RoundRobinPolicy,
    "scorpio": ScorpioPolicy,
    "aladdin": AladdinPolicy,
    "sa": SAPolicy,
}


def make_policy(name: str, latency_model, monitor, on_dispatch,
                **kw) -> BasePolicy:
    return POLICIES[name](latency_model, monitor, on_dispatch, **kw)
