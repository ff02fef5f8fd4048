"""Multi-SLO-aware Dispatcher (paper §5.1, Algorithm 1).

Centralized scheduler.  Requests wait in Q_R ordered by (TPOT, arrival);
workers sit in Q_W ordered by *maturity time* — the earliest moment a
worker can take new load without endangering deadlines.  A dispatch pass
pops the maturest worker, computes its token budget (Eq. 5), scans Q_R
admitting requests whose TTFT-attainment probability `calculate_p`
clears the threshold theta, dispatches, and re-inserts the worker with

    maturity <- now + E_p + (E_p / relax) * E_d,
    relax = min TPOT(waiting + new + running) - E_d

so the prefill stall is amortized against the decode slack.

State observation goes through the Monitor's snapshots plus a local
*shadow* (requests this dispatcher just placed) — the paper's
"synchronize in background, update local state after dispatch".

Workers are :class:`~repro_torch.serving.backend.Backend` instances; the
dispatcher only reads the protocol surface (``waiting`` / ``running``
views, ``kv_capacity``, ``kv_tokens()``), so the same instance
schedules simulated and real-engine planes unmodified.

A copy of ``repro/core/dispatcher.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.monitor import Monitor
from repro_torch.core.queues import RequestPriorityQueue, WorkerPriorityQueue
from repro_torch.core.request import Request
from repro_torch.core.token_budget import maturity_interval, ntoken_limit

INF = float("inf")


def _suffix(l_in: int, hit: int) -> int:
    """Prompt tokens that actually need prefill compute after a
    prefix-cache hit of ``hit`` tokens (>= 1: the engine always
    re-prefills at least one token for the first-token logits)."""
    return max(1, l_in - hit)


@dataclasses.dataclass
class DispatcherConfig:
    theta: float = 0.55          # admission probability threshold
    admit_overdue: bool = True   # never starve already-late requests
    scan_limit: int = 512        # max Q_R entries examined per pass
    default_ttft: float = 10.0
    default_tpot: float = 1.0


@dataclasses.dataclass
class AdmissionVerdict:
    """Submit-time admit/reject decision (proactive admission control).

    Produced by :meth:`Dispatcher.admission_verdict` from the same
    Eq. 5 / ``calculate_p`` machinery a dispatch pass uses — but
    evaluated when the request is *submitted*, so an online client
    learns immediately that a request is doomed instead of watching it
    queue past its deadline.
    """

    admit: bool
    p: float                     # best TTFT-attainment prob. over workers
    wid: Optional[int] = None    # worker achieving it
    est_ttft: float = 0.0        # estimated TTFT on that worker (s)
    reason: str = ""             # human-readable refusal cause


class WorkerShadow:
    """Monitor snapshot + local deltas for one worker."""

    def __init__(self, worker):
        self.worker = worker
        self.snap_time = -INF
        self.cur_lens: list[int] = []
        self.waiting_lens: list[int] = []
        self.waiting_slos: list[tuple[float, float]] = []
        self.running_tpots: list[float] = []
        self.kv_tokens = 0
        self.utilization = 0.0

    def refresh(self, snap) -> None:
        if snap is None or snap.time <= self.snap_time:
            return
        self.snap_time = snap.time
        self.cur_lens = list(snap.cur_lens)
        self.kv_tokens = snap.kv_tokens
        self.utilization = snap.utilization
        self.waiting_lens = []
        self.waiting_slos = []
        # waiting set is re-derived from live worker (the dispatcher owns
        # placement, so its own view of the waiting set is authoritative).
        # Lengths are the *uncached suffix* — prefix-cache hits skip
        # prefill compute, so only the suffix loads the Eq. 5 budget
        # (kv_tokens still charges the full l_in: shared pages are
        # resident either way)
        for r in self.worker.waiting:
            self.waiting_lens.append(_suffix(r.l_in, r.prefix_hit_tokens))
            self.waiting_slos.append((r.ttft_slo, r.tpot_slo))
        self.running_tpots = [r.tpot_slo for r in self.worker.running]

    def after_dispatch(self, reqs: Iterable[Request]) -> None:
        for r in reqs:
            self.waiting_lens.append(_suffix(r.l_in, r.prefix_hit_tokens))
            self.waiting_slos.append((r.ttft_slo, r.tpot_slo))
            self.kv_tokens += r.l_in


class Dispatcher:
    """Prefill-stage / collocated scheduler (Algorithm 1)."""

    def __init__(self, latency_model: LatencyModel, monitor: Monitor,
                 cfg: Optional[DispatcherConfig] = None,
                 on_dispatch: Optional[Callable] = None,
                 load_calc=None):
        self.model = latency_model
        self.monitor = monitor
        # None sentinel: a dataclass default evaluated in the signature
        # would be ONE shared object across every Dispatcher instance
        self.cfg = DispatcherConfig() if cfg is None else cfg
        self.on_dispatch = on_dispatch
        # optional InstanceLoadCalculator: breaks admission ties (equal
        # TTFT-attainment probability) toward the less-loaded worker,
        # so placement agrees with migration/scaling about "loaded"
        self.load_calc = load_calc
        self.qr = RequestPriorityQueue()
        self.qw = WorkerPriorityQueue()
        self.shadows: dict[int, WorkerShadow] = {}
        self._maturity: dict[int, float] = {}

    # -- workers ---------------------------------------------------------------
    def add_worker(self, worker, now: float) -> None:
        self.shadows[worker.wid] = WorkerShadow(worker)
        self._maturity[worker.wid] = now
        self.qw.push(worker, now)

    def remove_worker(self, wid: int) -> None:
        self.shadows.pop(wid, None)
        self._maturity.pop(wid, None)
        # lazily dropped from Q_W on pop

    def notify_worker_free(self, wid: int, now: float) -> None:
        """Maturity correction (paper §5.1: 'periodic telemetry ...
        used to correct delayed observations').  Called when a worker
        finishes a step earlier than the estimate — pull its maturity in
        so the next pass can feed it immediately, and fold the
        completion event into the shadow (event-driven state update, so
        a slow Monitor interval degrades gracefully — Fig. 8)."""
        if wid not in self.shadows:
            return
        shadow = self.shadows[wid]
        w = shadow.worker
        shadow.cur_lens = [r.cur_len for r in w.running]
        shadow.running_tpots = [r.tpot_slo for r in w.running]
        shadow.kv_tokens = w.kv_tokens()
        shadow.waiting_lens = [_suffix(r.l_in, r.prefix_hit_tokens)
                               for r in w.waiting]
        shadow.waiting_slos = [(r.ttft_slo, r.tpot_slo)
                               for r in w.waiting]
        if now < self._maturity.get(wid, 0.0):
            self._maturity[wid] = now
            self.qw.push(w, now)

    # -- request intake ----------------------------------------------------------
    def on_request_arrive(self, r: Request) -> None:
        self.qr.add(r)

    def pending(self) -> int:
        return len(self.qr)

    # -- Algorithm 1 helpers -----------------------------------------------------
    def _free_tokens(self, shadow: WorkerShadow) -> int:
        cap = shadow.worker.kv_capacity
        return max(0, cap - shadow.kv_tokens)

    def _tightest_slos(self, shadow: WorkerShadow) -> tuple[float, float]:
        ttfts = [s[0] for s in shadow.waiting_slos]
        tpots = [s[1] for s in shadow.waiting_slos] + shadow.running_tpots
        head = self.qr.peek()
        if head is not None:
            ttfts.append(head.ttft_slo)
            tpots.append(head.tpot_slo)
        ttft = min(ttfts) if ttfts else self.cfg.default_ttft
        tpot = min(tpots) if tpots else self.cfg.default_tpot
        return ttft, tpot

    def get_ntoken(self, shadow: WorkerShadow) -> int:
        ttft, tpot = self._tightest_slos(shadow)
        e_d = self.model.decode_step_time(shadow.cur_lens)
        return ntoken_limit(ttft, tpot, e_d, self.model)

    def _request_cost(self, r: Request, shadow: WorkerShadow) -> int:
        """Prompt tokens ``r`` would actually prefill on this worker:
        the uncached suffix after the worker's prefix-cache hit (full
        l_in when the plane has no cache)."""
        return _suffix(r.l_in, shadow.worker.prefix_peek(r))

    def calculate_p(self, r: Request, shadow: WorkerShadow,
                    now: float) -> float:
        """TTFT-attainment probability in [0, 1] (Algorithm 1)."""
        e_p = self.model.prefill_time(
            shadow.waiting_lens + [self._request_cost(r, shadow)]
        )
        t_remaining = (r.arrival + r.ttft_slo) - (now + e_p)
        slack = t_remaining / max(r.ttft_slo, 1e-6)
        util = shadow.utilization
        return max(0.0, min(1.0, 0.5 + slack * (1.0 - 0.5 * util)))

    # -- submit-time admission (online serving front door) ------------------------
    def admission_verdict(self, r: Request, now: float) -> AdmissionVerdict:
        """Evaluate the Eq. 5 budget estimate for ``r`` at submit time.

        Read-only: scans the worker shadows (snapshot + local deltas —
        the same possibly-slightly-stale view a dispatch pass budgets
        with) for the best TTFT-attainment probability and rejects when
        no worker clears theta.  The caller decides what a rejection
        means (refuse outright, or degrade the SLO and admit anyway).
        """
        best: Optional[AdmissionVerdict] = None
        best_load: Optional[float] = None
        for wid, shadow in self.shadows.items():
            w = shadow.worker
            if not w.active:
                continue
            if r.l_in > w.kv_capacity:
                continue  # this worker could never hold the prompt
            p = self.calculate_p(r, shadow, now)
            e_p = self.model.prefill_time(
                shadow.waiting_lens + [self._request_cost(r, shadow)]
            )
            arrival = r.arrival if r.arrival is not None else now
            est = max(0.0, (now + e_p) - arrival)
            load = (self.load_calc.load(w)
                    if self.load_calc is not None else None)
            better = best is None or p > best.p + 1e-9
            if (not better and best is not None and load is not None
                    and abs(p - best.p) <= 1e-9 and best_load is not None
                    and load < best_load):
                # idle/near-idle workers all saturate p: the unified
                # load signal breaks the tie instead of dict order
                better = True
            if better:
                best = AdmissionVerdict(False, p, wid, est)
                best_load = load
        if best is None:
            return AdmissionVerdict(
                False, 0.0, None, INF,
                reason="no active worker can hold the prompt",
            )
        best.admit = best.p >= self.cfg.theta
        if not best.admit:
            best.reason = (f"TTFT-attainment probability {best.p:.2f} "
                           f"below theta={self.cfg.theta}")
        return best

    # -- the dispatch pass ---------------------------------------------------------
    def dispatch_pass(self, now: float) -> list[tuple]:
        """Run Algorithm 1 until no mature worker or empty queue.

        Returns [(worker, [requests]), ...] of performed dispatches.
        """
        done = []
        while self.qr:
            w, maturity = self.qw.peek()
            if w is None or maturity > now:
                break
            self.qw.pop()
            if w.wid not in self.shadows or not w.active:
                continue  # scaled-in
            if abs(maturity - self._maturity.get(w.wid, maturity)) > 1e-12:
                continue  # stale duplicate entry (maturity was corrected)
            shadow = self.shadows[w.wid]
            shadow.refresh(self.monitor.snapshot(w.wid))

            # Eq. 5 bounds the worker's total uncommitted prompt tokens:
            # tokens already waiting for prefill count against the budget.
            committed = sum(shadow.waiting_lens)
            token_limit = min(self._free_tokens(shadow),
                              self.get_ntoken(shadow) - committed)
            selected: list[Request] = []
            overdue_pool: list[Request] = []
            costs: dict[int, int] = {}
            used = 0
            # Eq. 5 charges the *uncached suffix*: a prefix-cache hit
            # shrinks the prefill work this worker would actually run,
            # so more (or longer) requests fit the same token budget
            for i, r in enumerate(self.qr.scan()):
                if i >= self.cfg.scan_limit:
                    break
                cost = self._request_cost(r, shadow)
                if used + cost > token_limit:
                    continue
                if self.calculate_p(r, shadow, now) >= self.cfg.theta:
                    selected.append(r)
                    costs[r.rid] = cost
                    used += cost
                elif self.cfg.admit_overdue and r.deadline() <= now:
                    overdue_pool.append(r)
            # already-late requests only fill the leftover budget, so
            # they never push still-savable requests past their TTFT
            for r in overdue_pool:
                cost = self._request_cost(r, shadow)
                if used + cost > token_limit:
                    continue
                selected.append(r)
                costs[r.rid] = cost
                used += cost
            for r in selected:
                self.qr.remove(r)
                r.dispatch_time = now
                # provisional hit estimate so the shadow's waiting_lens
                # budget the suffix; the executing plane re-stamps the
                # actual hit at prefill time
                r.prefix_hit_tokens = max(0, r.l_in - costs[r.rid])
            if selected:
                shadow.after_dispatch(selected)
                if self.on_dispatch is not None:
                    self.on_dispatch(w, selected, now)
                done.append((w, selected))

            # next maturity (Algorithm 1 tail)
            e_p = self.model.prefill_time(shadow.waiting_lens)
            all_lens = shadow.cur_lens + shadow.waiting_lens
            e_d = self.model.decode_step_time(all_lens)
            tpots = ([s[1] for s in shadow.waiting_slos]
                     + shadow.running_tpots)
            min_tpot = min(tpots) if tpots else self.cfg.default_tpot
            interval = maturity_interval(e_p, e_d, min_tpot)
            if not selected and not e_p:
                # idle worker with nothing admitted: poll again shortly
                interval = max(interval, 0.01)
            self._maturity[w.wid] = now + interval
            self.qw.push(w, now + interval)
        return done

    def next_wakeup(self) -> Optional[float]:
        _, maturity = self.qw.peek()
        return maturity
