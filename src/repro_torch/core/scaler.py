"""SLO-aware scaling controller (paper §6, Algorithm 3).

Every tau seconds the scaler computes a load metric

    LoadMetric = f(Utils, T_wait, R_in, R_process)

and scales out above epsilon_o / in below epsilon_i (sustained).  For
P/D-disaggregated deployments each pool is scaled independently and,
when demand diverges, an idle worker *switches roles* instead of
churning instances (engines are role-agnostic; links are bidirectional).

Cold starts use the Fast Scaling path: a warm pool of runtime-initialized
instances pulls weights D2D from a live WeightManager via the TLManager,
falling back to host-offload or disk (Table 2 strategies).

Workers are :class:`~repro_torch.serving.backend.Backend` instances — the
scaler reads only Monitor snapshots and the protocol's ``waiting`` /
``running`` views, so the same instance scales simulated and
real-engine planes; the Cluster's worker factory decides which plane a
scaled-out replica lands on.

A copy of ``repro/core/scaler.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.monitor import Monitor
from repro_torch.core.tlmanager import TLManager


@dataclasses.dataclass
class ScalerConfig:
    tau: float = 1.0              # scaling interval (Fig. 8 knob)
    eps_out: float = 0.85         # upper threshold
    eps_in: float = 0.25          # lower threshold
    sustain_in: int = 3           # consecutive low-load ticks before scale-in
    max_workers: int = 4
    min_workers: int = 1
    # "d2d" | "cpu" | "disk" (Table 2) | "auto" (pick the cheapest by
    # the TLManager's measured-or-analytic cost each scale-out)
    weight_strategy: str = "d2d"
    warm_pool: bool = True        # pre-initialized CPU runtimes
    warm_pool_size: int = 1       # concurrent warm runtimes held ready
    role_transition_time: float = 0.08  # P<->D flip (link/role flip only)


@dataclasses.dataclass
class ScaleAction:
    kind: str          # "out" | "in" | "role"
    role: str          # target role for the new/flipped worker
    delay: float       # provisioning latency before the worker serves
    worker_id: Optional[int] = None  # for "in"/"role"
    strategy: Optional[str] = None   # "out": weight transport chosen
    warm: bool = True                # "out": consumed a warm runtime


class Scaler:
    def __init__(self, cfg: ScalerConfig, monitor: Monitor, tl: TLManager,
                 model_cfg: ModelConfig, tp: int = 1, *,
                 load_calc=None, evacuate: bool = False):
        self.cfg = cfg
        self.monitor = monitor
        self.tl = tl
        self.model_cfg = model_cfg
        self.tp = tp
        # optional shared InstanceLoadCalculator: scale-in / role-flip
        # targets become the LEAST-loaded candidate instead of list
        # order.  evacuate=True (cluster live-migration mode) lets a
        # non-drained worker be targeted — the cluster migrates its
        # residents off and commits when it empties (migrate-then-flip
        # instead of drain-and-flip)
        self.load_calc = load_calc
        self.evacuate = evacuate
        self.last_decision = -1e18
        self._low_ticks: dict[str, int] = {}
        self.n_scale_out = 0
        self.n_scale_in = 0
        self.n_role_flips = 0
        # warm-pool occupancy: consumed at scale-out, replenished
        # runtime_warmup seconds later (a replacement runtime starts
        # initializing the moment one is taken) — concurrent
        # scale-outs beyond the pool pay the cold runtime init
        self._warm_free = cfg.warm_pool_size if cfg.warm_pool else 0
        self._warm_refill: list[float] = []

    # -- load metric ------------------------------------------------------------
    def load_metric(self, now: float, workers, queued) -> float:
        """f(Utils, T_wait, R_in, R_process) — normalized ~[0, 1.5]."""
        active = [w for w in workers if w.active]
        if not active:
            return 2.0
        utils = [
            (self.monitor.snapshot(w.wid).utilization
             if self.monitor.snapshot(w.wid) else 0.0)
            for w in active
        ]
        util_avg = sum(utils) / len(utils)
        # worst queued wait relative to its TTFT SLO
        wait_frac = 0.0
        for r in queued:
            frac = (now - r.arrival) / max(r.ttft_slo, 1e-6)
            wait_frac = max(wait_frac, frac)
        rate_ratio = self.monitor.rate_in / max(self.monitor.rate_done, 0.25)
        return max(util_avg,
                   min(wait_frac, 2.0) / 2.0,
                   min(rate_ratio, 2.0) / 2.0)

    # -- warm pool (Fast Scaling runtime pre-init) -------------------------------
    def warm_available(self, now: float) -> int:
        """Warm runtimes ready at ``now`` (matured refills folded in)."""
        ready = [t for t in self._warm_refill if t <= now]
        if ready:
            self._warm_refill = [t for t in self._warm_refill if t > now]
            self._warm_free = min(self._warm_free + len(ready),
                                  self.cfg.warm_pool_size)
        return self._warm_free

    def _take_warm(self, now: float) -> bool:
        """Consume one warm runtime; schedules its replacement's init.
        False when the pool is dry — that scale-out pays
        ``runtime_warmup`` on top of the weight transfer."""
        if not self.cfg.warm_pool or self.warm_available(now) <= 0:
            return False
        self._warm_free -= 1
        self._warm_refill.append(now + self.tl.costs.runtime_warmup)
        return True

    # -- provisioning path (Table 2) ---------------------------------------------
    def choose_strategy(self, has_donor: bool) -> str:
        """Pick the weight transport for this scale-out.  ``d2d``
        needs a live donor replica holding the weights — without one
        (scale-from-zero) it degrades to ``disk``.  ``auto`` takes the
        cheapest available path by the TLManager's measured-or-analytic
        cost model (probe only: no bytes booked)."""
        s = self.cfg.weight_strategy
        if s == "auto":
            cands = ["cpu", "disk"] + (["d2d"] if has_donor else [])
            return min(cands, key=lambda c: self.tl.weight_load_time(
                self.model_cfg, c, tp=self.tp, record=False))
        if s == "d2d" and not has_donor:
            return "disk"
        return s

    def provision_delay(self, now: float,
                        strategy: Optional[str] = None) -> tuple[float, bool]:
        """Provisioning latency for one scale-out at ``now``; consumes
        a warm runtime when one is ready.  Returns ``(delay, warm)``."""
        if strategy is None:
            strategy = self.cfg.weight_strategy
        warm = self._take_warm(now)
        t = self.tl.weight_load_time(
            self.model_cfg, strategy, tp=self.tp, warm=warm,
        )
        return t, warm


    # -- target selection ---------------------------------------------------------
    @staticmethod
    def _committed(ws) -> list:
        """Workers that will still serve this pool after in-flight
        actions settle: active and not being evacuated.  Pool-size
        guards count these — counting an evacuating worker would let a
        second flip empty the pool the first one is already leaving."""
        return [w for w in ws
                if w.active and not getattr(w, "evacuating", False)]

    def _scale_target(self, ws):
        """Scale-in / role-flip target.  Drained workers are free to
        take; with ``evacuate`` (live migration) a loaded worker may be
        targeted too — the cluster moves its residents off and commits
        when it drains.  Least-loaded first when a load calculator is
        wired, so the cheapest evacuation is always picked."""
        act = self._committed(ws)
        cands = [w for w in act if w.is_drained()]
        if not cands and self.evacuate:
            cands = act
        if not cands:
            return None
        if self.load_calc is not None:
            return min(cands, key=lambda w: (self.load_calc.load(w),
                                             w.wid))
        return cands[0]

    # -- Algorithm 3 --------------------------------------------------------------
    def tick(self, now: float, workers, queued, *,
             pool: str = "any") -> list[ScaleAction]:
        if now - self.last_decision < self.cfg.tau:
            return []
        self.last_decision = now
        actions: list[ScaleAction] = []
        pool_workers = [w for w in workers
                        if pool == "any" or w.role == pool]
        load = self.load_metric(now, pool_workers, queued)
        n_active = len(self._committed(pool_workers))
        n_total_active = sum(1 for w in workers if w.active)

        key = pool
        if load > self.cfg.eps_out:
            self._low_ticks[key] = 0
            if n_total_active < self.cfg.max_workers:
                strategy = self.choose_strategy(
                    has_donor=n_total_active > 0
                )
                delay, warm = self.provision_delay(now, strategy)
                actions.append(ScaleAction("out", pool, delay,
                                           strategy=strategy, warm=warm))
                self.n_scale_out += 1
        elif load < self.cfg.eps_in:
            self._low_ticks[key] = self._low_ticks.get(key, 0) + 1
            if (self._low_ticks[key] >= self.cfg.sustain_in
                    and n_active > self.cfg.min_workers):
                # active only: a deactivated-but-drained worker must
                # never be "scaled in" again (double-counts the action
                # and leaves the actually-loaded worker running)
                target = self._scale_target(pool_workers)
                if target is not None:
                    actions.append(
                        ScaleAction("in", pool, 0.0,
                                    worker_id=target.wid)
                    )
                    self.n_scale_in += 1
                    self._low_ticks[key] = 0
        else:
            self._low_ticks[key] = 0
        return actions

    # -- P/D coordinated tick -------------------------------------------------------
    def tick_pd(self, now: float, workers, prefill_queued,
                decode_queued) -> list[ScaleAction]:
        """Independent pool scaling + role transitions (paper §6)."""
        if now - self.last_decision < self.cfg.tau:
            return []
        self.last_decision = now
        p_pool = [w for w in workers if w.role == "prefill"]
        d_pool = [w for w in workers if w.role == "decode"]
        p_load = self.load_metric(now, p_pool, prefill_queued)
        d_load = self.load_metric(now, d_pool, decode_queued)
        actions: list[ScaleAction] = []
        n_active = sum(1 for w in workers if w.active)

        # role transitions first: avoid churn when demand diverges.
        # Without live migration only drained ACTIVE workers flip
        # (drain-and-flip: Backend.is_drained includes parked KV
        # awaiting migration); with evacuate the least-loaded worker is
        # targeted and the cluster migrates it empty (migrate-then-
        # flip).  Pool-size guards count committed active workers only —
        # deactivated replicas keep their role and would otherwise
        # inflate the pool, letting the last active worker flip away,
        # and an already-evacuating worker is leaving its pool.
        def n_act(ws):
            return len(self._committed(ws))

        if (p_load > self.cfg.eps_out and d_load < self.cfg.eps_in
                and n_act(d_pool) > self.cfg.min_workers):
            w = self._scale_target(d_pool)
            if w is not None:
                actions.append(ScaleAction(
                    "role", "prefill", self.cfg.role_transition_time,
                    worker_id=w.wid,
                ))
                self.n_role_flips += 1
                return actions
        if (d_load > self.cfg.eps_out and p_load < self.cfg.eps_in
                and n_act(p_pool) > self.cfg.min_workers):
            w = self._scale_target(p_pool)
            if w is not None:
                actions.append(ScaleAction(
                    "role", "decode", self.cfg.role_transition_time,
                    worker_id=w.wid,
                ))
                self.n_role_flips += 1
                return actions

        for role, load, pool, queued in (
            ("prefill", p_load, p_pool, prefill_queued),
            ("decode", d_load, d_pool, decode_queued),
        ):
            if load > self.cfg.eps_out and n_active < self.cfg.max_workers:
                strategy = self.choose_strategy(has_donor=n_active > 0)
                delay, warm = self.provision_delay(now, strategy)
                actions.append(ScaleAction("out", role, delay,
                                           strategy=strategy, warm=warm))
                self.n_scale_out += 1
                n_active += 1
            elif load < self.cfg.eps_in:
                k = role
                self._low_ticks[k] = self._low_ticks.get(k, 0) + 1
                if (self._low_ticks[k] >= self.cfg.sustain_in
                        and n_act(pool) > self.cfg.min_workers):
                    target = self._scale_target(pool)
                    if target is not None:
                        actions.append(ScaleAction(
                            "in", role, 0.0, worker_id=target.wid
                        ))
                        self.n_scale_in += 1
                        self._low_ticks[k] = 0
            else:
                self._low_ticks[role] = 0
        return actions
