"""Migrator: decode-stage scheduler for P/D disaggregation (paper §5.1)
and the live decode-to-decode MigrationCoordinator built on the same
admission math.

Two-stage scheduling: the Dispatcher places the *prefill* stage only; a
request whose prefill completed enters the Migrator's queue, and the
decode instance is chosen **then**, against the decode pool's actual
load — fixing the two failure modes of one-shot dispatching (unknown
prefill completion time, unknown future decode load).

Decode workers are interruptible per iteration, so maturity is the end
of the current decode step.  Admission: a request joins worker w only if
the predicted next-step cost E_d(B ∪ {r}) stays within the tightest
TPOT of the merged batch and the KV cache fits.  The KV cache transfer
is costed by the TLManager and the request only joins the batch when the
transfer lands.

Both planners charge in-flight transfers to their destination through a
shared :class:`~repro_torch.core.instance_load.ReservationLedger` — a request
whose ``kv_ready`` is scheduled but not yet ``accept_migrated`` is
invisible in the destination's ``running``/``waiting`` views, and
without the ledger successive passes overcommit one worker's KV and
TPOT budget (the engine plane then silently preempts-youngest).

A copy of ``repro/core/migrator.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.instance_load import (
    InstanceLoadCalculator,
    ReservationLedger,
)
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.monitor import Monitor
from repro_torch.core.queues import RequestPriorityQueue
from repro_torch.core.request import Request
from repro_torch.core.tlmanager import TLManager


@dataclasses.dataclass
class MigratorConfig:
    headroom: float = 0.95   # fraction of TPOT the predicted E_d may use
    scan_limit: int = 256


class Migrator:
    def __init__(self, latency_model: LatencyModel, monitor: Monitor,
                 tl: TLManager, model_cfg: ModelConfig, tp: int = 1,
                 cfg: Optional[MigratorConfig] = None,
                 on_migrate: Optional[Callable] = None,
                 measure_bytes: Optional[Callable] = None,
                 ledger: Optional[ReservationLedger] = None):
        self.model = latency_model
        self.monitor = monitor
        self.tl = tl
        self.model_cfg = model_cfg
        self.tp = tp
        # None sentinel: a dataclass default evaluated in the signature
        # would be ONE shared object across every Migrator instance
        self.cfg = MigratorConfig() if cfg is None else cfg
        self.on_migrate = on_migrate
        # engine plane: returns the request's *measured* KV payload
        # bytes (None -> fall back to the analytic per-token estimate)
        self.measure_bytes = measure_bytes
        self.ledger = ledger if ledger is not None else ReservationLedger()
        self.queue = RequestPriorityQueue()  # prefilled, awaiting decode

    def on_prefill_complete(self, r: Request) -> None:
        self.queue.add(r)

    def pending(self) -> int:
        return len(self.queue)

    # -- the migration pass ------------------------------------------------------
    def migrate_pass(self, now: float, decode_workers) -> list[tuple]:
        """Assign prefilled requests to decode workers; returns
        [(request, worker, transfer_time), ...]."""
        out = []
        workers = [w for w in decode_workers if w.active]
        if not workers:
            return out
        led = self.ledger
        for i, r in enumerate(list(self.queue.scan())):
            if i >= self.cfg.scan_limit:
                break
            best = None
            best_slack = None
            for w in workers:
                # pending (in-flight) migrations count toward the load:
                # the ledger charges every scheduled-but-not-landed
                # transfer's tokens and TPOT to its destination
                lens = ([q.cur_len for q in w.running]
                        + [q.cur_len for q in w.waiting]
                        + led.lens(w.wid))
                if (w.kv_capacity - w.kv_tokens()
                        - led.tokens(w.wid)) < r.cur_len:
                    continue
                e_d = self.model.decode_step_time(lens + [r.cur_len])
                tpots = ([q.tpot_slo for q in w.running]
                         + [q.tpot_slo for q in w.waiting]
                         + led.tpots(w.wid)
                         + [r.tpot_slo])
                budget = min(tpots) * self.cfg.headroom
                slack = budget - e_d
                if slack >= 0 and (best_slack is None
                                   or slack > best_slack):
                    best, best_slack = w, slack
            if best is None:
                continue
            self.queue.remove(r)
            # worker id 0 is a valid prefill worker — never `or 0` here
            assert r.prefill_worker is not None, (
                f"request {r.rid} reached migrate_pass without a "
                f"prefill_worker; on_prefill_complete fired too early"
            )
            nbytes = (self.measure_bytes(r)
                      if self.measure_bytes is not None else None)
            t_x = self.tl.kv_transfer_time(
                self.model_cfg, r.l_in, src=r.prefill_worker,
                dst=best.wid, tp=self.tp, nbytes=nbytes,
            )
            led.reserve(best.wid, r)
            r.decode_worker = best.wid
            r.migrate_ready = now + t_x
            if self.on_migrate is not None:
                self.on_migrate(r, best, now, t_x)
            out.append((r, best, t_x))
        return out


@dataclasses.dataclass
class MigrationConfig:
    """Knobs for live decode-to-decode migration."""

    headroom: float = 0.95   # destination admission, same as Migrator
    trigger: float = 1.0     # pressure above which a replica sheds load
    max_moves: int = 4       # moves planned per pass
    cooldown: float = 0.25   # s a landed request is pinned before it
                             # may move again (anti-ping-pong)
    min_remaining: int = 4   # don't move nearly-finished requests: the
                             # transfer would outlive the stream


class MigrationCoordinator:
    """Victim/destination pairing for live decode-to-decode migration.

    Generalizes the Migrator's one-way prefill→decode hand-off: any
    *decoding* request can be checkpointed mid-stream (``export_kv``
    captures its newest tokens at transfer completion), moved with
    TLManager-costed bytes, and resumed token-identically.  Victims
    come from two places:

    - **evacuation** — every running request on a worker the Scaler
      targeted for scale-in or a role flip (migrate-then-flip instead
      of drain-and-flip);
    - **rescue** — workers whose :class:`InstanceLoadCalculator`
      pressure predicts a TPOT miss shed load until the predicted step
      fits the batch's tightest budget again (this is also what
      rebalances bursty ramps).

    Destinations are ranked by the shared load scalar among workers
    that pass the Migrator's admission math (reservations included),
    so migration never overcommits what dispatch is also filling.
    """

    def __init__(self, load_calc: InstanceLoadCalculator,
                 latency_model: LatencyModel, tl: TLManager,
                 model_cfg: ModelConfig, tp: int = 1,
                 cfg: Optional[MigrationConfig] = None,
                 measure_bytes: Optional[Callable] = None):
        self.load_calc = load_calc
        self.ledger = load_calc.ledger
        self.model = latency_model
        self.tl = tl
        self.model_cfg = model_cfg
        self.tp = tp
        self.cfg = MigrationConfig() if cfg is None else cfg
        # engine plane: (request, src_wid) -> measured payload bytes
        self.measure_bytes = measure_bytes
        self.n_rescues = 0
        self.n_evacuations = 0

    # -- admission (same math as Migrator.migrate_pass) ---------------------------
    def _dest_ok(self, r: Request, w) -> bool:
        led = self.ledger
        if (w.kv_capacity - w.kv_tokens()
                - led.tokens(w.wid)) < r.cur_len:
            return False
        lens = ([q.cur_len for q in w.running]
                + [q.cur_len for q in w.waiting]
                + led.lens(w.wid))
        e_d = self.model.decode_step_time(lens + [r.cur_len])
        tpots = ([q.tpot_slo for q in w.running]
                 + [q.tpot_slo for q in w.waiting]
                 + led.tpots(w.wid)
                 + [r.tpot_slo])
        return e_d <= min(tpots) * self.cfg.headroom

    def _movable(self, r: Request, now: float) -> bool:
        if r.migrating or r.kv_payload is not None:
            return False
        if r.l_out - r.tokens_done < self.cfg.min_remaining:
            return False
        if (r.last_migrated is not None
                and now - r.last_migrated < self.cfg.cooldown):
            return False
        return True

    def _rescue_victims(self, src, now: float) -> list[Request]:
        """Shed just enough of ``src``'s decode batch to bring the
        predicted step back under the tightest remaining TPOT budget.
        Loosest-TPOT, longest-context requests go first: they have the
        most slack to survive the transfer and removing them shrinks
        E_d the most."""
        remaining = list(src.running)
        out: list[Request] = []
        for r in sorted(src.running,
                        key=lambda q: (-q.tpot_slo, -q.cur_len)):
            lens = [q.cur_len for q in remaining]
            tpots = [q.tpot_slo for q in remaining]
            if not lens or (self.model.decode_step_time(lens)
                            <= min(tpots) * self.cfg.headroom):
                break
            if not self._movable(r, now):
                continue
            out.append(r)
            remaining.remove(r)
        return out

    # -- the planning pass --------------------------------------------------------
    def plan(self, now: float, workers,
             evacuating=()) -> list[tuple]:
        """One planning pass; returns
        [(request, src_worker, dst_worker, transfer_time, reason), ...].
        Reserves each move on its destination — the caller schedules
        the transfer and releases the reservation at ``kv_ready``."""
        evac = set(evacuating)

        def is_evac(w) -> bool:
            return w.wid in evac or getattr(w, "evacuating", False)

        dests = [w for w in workers
                 if w.active and not is_evac(w)
                 and w.role in ("decode", "collocated")]
        moves: list[tuple] = []
        for src in workers:
            if len(moves) >= self.cfg.max_moves:
                break
            if not src.active:
                continue
            if is_evac(src):
                victims = [r for r in src.running
                           if self._movable(r, now)]
                reason = "evac"
            elif (src.role in ("decode", "collocated")
                    and src.running
                    and self.load_calc.pressure(src) > self.cfg.trigger):
                victims = self._rescue_victims(src, now)
                reason = "rescue"
            else:
                continue
            pool = [w for w in dests if w.wid != src.wid]
            for r in victims:
                if len(moves) >= self.cfg.max_moves:
                    break
                cands = [w for w in pool if self._dest_ok(r, w)]
                if not cands:
                    continue
                best = min(cands, key=lambda w: (self.load_calc.load(w),
                                                 w.wid))
                nbytes = (self.measure_bytes(r, src.wid)
                          if self.measure_bytes is not None else None)
                t_x = self.tl.kv_transfer_time(
                    self.model_cfg, r.cur_len, src=src.wid,
                    dst=best.wid, tp=self.tp, nbytes=nbytes,
                )
                self.ledger.reserve(best.wid, r)
                r.migrating = True
                if reason == "evac":
                    self.n_evacuations += 1
                else:
                    self.n_rescues += 1
                moves.append((r, src, best, t_x, reason))
        return moves
