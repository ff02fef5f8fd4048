"""Replica-failure recovery and transfer retry (the serving plane's
fault-tolerance half; `core/faults.py` is the injection half).

One :class:`RecoveryManager` drives BOTH execution planes through the
Backend protocol:

- **Health watchdog** — runs on every monitor tick.  Detects replicas
  marked crashed by the fault schedule (detection latency = the monitor
  interval, like a real heartbeat) and, optionally, requests whose
  token progress has stalled past ``stuck_timeout`` on a live worker.
- **Replica crash** — the dead worker's weight tree is released, its
  prefix-cache pins and ReservationLedger charges dropped, and every
  in-flight resident is re-queued for re-dispatch: generated tokens are
  folded into the prompt (the engine's recompute-preemption idiom, so
  greedy re-prefill is token-exact) and the ORIGINAL arrival stamp is
  kept — Eq. 5 budgets and attainment see the true degradation.
  Re-admission is SLO-aware: the policy's admission verdict may degrade
  (stretch the TTFT SLO to the achievable estimate) or shed (FAILED)
  when the lost capacity makes the request unservable.
- **Transfer retry** — a dropped KV transfer (P/D hand-off or live
  decode-to-decode migration) releases its ledger charge and retries
  with capped exponential backoff on an alternate destination chosen by
  the Migrator's admission math; when retries exhaust or no destination
  admits, a live move falls back to source-continues-decode and a P/D
  hand-off re-enters the Migrator queue (or re-prefills if the source
  died too).

The Scaler needs no coupling: a crash drops active capacity, queued
work raises the load signal, and the next tick replaces the replica
through the normal scale-out path (d2d -> cpu -> disk fallback included
when the donor died mid-pull).

A copy of ``repro/serving/recovery.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.core.request import Request, RequestState

if TYPE_CHECKING:
    from repro_torch.serving.cluster import Cluster


@dataclasses.dataclass
class RecoveryConfig:
    max_transfer_retries: int = 3
    retry_backoff: float = 0.05      # s; doubles per attempt
    retry_backoff_cap: float = 0.5
    # TTFT-SLO stretch when re-admission degrades (same semantics as
    # ServingSession's admission="degrade")
    degrade_factor: float = 1.25
    # requests whose token progress stalls this long on a LIVE worker
    # are pulled off and re-dispatched; None disables the scan
    stuck_timeout: Optional[float] = None
    headroom: float = 0.95           # retry-destination admission math


class RecoveryManager:
    """Failure-recovery policy over one Cluster (either plane)."""

    def __init__(self, cluster: "Cluster",
                 cfg: Optional[RecoveryConfig] = None, *,
                 enabled: bool = True):
        self.cluster = cluster
        self.cfg = RecoveryConfig() if cfg is None else cfg
        # enabled=False is the ablation arm: faults still fire, but a
        # crash sheds its residents (FAILED) instead of re-queueing and
        # dropped transfers never retry
        self.enabled = enabled
        self._crash_t: dict[int, float] = {}     # wid -> crash time
        self._recovered_wids: set[int] = set()
        self._attempts: dict[int, int] = {}      # rid -> transfer retries
        # rid -> ((tokens_done, prefill_progress), last change time)
        self._progress: dict[int, tuple] = {}
        self.n_recovered = 0
        self.n_lost = 0
        self.n_transfer_retries = 0
        self.recovery_latency_s = 0.0   # sum of fault -> re-admission gaps

    # -- crash lifecycle -------------------------------------------------------
    def note_crash(self, wid: int, now: float) -> None:
        """Record the (virtual) death time; the watchdog detects it on
        the next monitor tick."""
        self._crash_t.setdefault(wid, now)

    def watchdog(self, now: float) -> None:
        """Monitor-tick health pass: recover crashed replicas, scan for
        stuck requests."""
        cl = self.cluster
        for w in list(cl.workers):
            if getattr(w, "crashed", False) and (
                    w.wid not in self._recovered_wids):
                self._recovered_wids.add(w.wid)
                self.crash_replica(w, now)
        if (not any(w.active and not getattr(w, "crashed", False)
                    for w in cl.workers)
                and cl.scaler is None):
            # total capacity loss with no replacement coming: queued
            # requests can never be served — shed them so no stream
            # consumer hangs forever (runs even with recovery disabled;
            # this is about termination, not re-admission)
            for r in list(cl.policy.queued_requests()):
                cl.policy.drop_request(r)
                self._shed(r, now, "no capacity")
        if self.cfg.stuck_timeout is not None:
            self._scan_stuck(now)

    def crash_replica(self, w, now: float) -> None:
        """Tear down a dead replica and re-home everything it held."""
        cl = self.cluster
        crash_t = self._crash_t.get(w.wid, now)
        if w.role in ("collocated", "prefill"):
            cl.policy.remove_worker(w.wid)
        # a pending evacuation of the corpse is moot — the deferred
        # scale-in/flip must not fire on it later
        cl._evac.pop(w.wid, None)
        w.evacuating = False
        residents = w.drop_all(now)
        # transfers in flight TOWARD the corpse can never land: clear
        # their destination charges so the load signal stops reserving
        # capacity on a dead replica (their kv_ready events no-op)
        cl._mig_ledger.drop_dst(w.wid)
        if cl.weights is not None and cl.weights.owns(w.wid):
            # the dead process's weight copy is gone with it; releasing
            # also removes it from the d2d donor pool
            cl.weights.release(w.wid)
            w.engine.release_weights()
        n_req = n_shed = 0
        # re-queue tightest-TPOT first: mass re-admission must preserve
        # the same (tpot_slo, arrival) order a fresh queue would have
        for r in sorted(residents,
                        key=lambda q: (q.tpot_slo, q.arrival or 0.0,
                                       q.rid)):
            if r.state == RequestState.FINISHED:
                continue
            if self._requeue_or_shed(r, now, reason="crash",
                                     fault_t=crash_t):
                n_req += 1
            else:
                n_shed += 1
        cl.timeline.append(
            (now, w.wid, f"recover:requeued={n_req},shed={n_shed}")
        )
        cl._schedule_dispatch(now)

    # -- re-admission ----------------------------------------------------------
    def _reset_for_requeue(self, r: Request) -> None:
        """Strip every trace of the dead placement.  Engine plane:
        fold generated tokens into the prompt (recompute-preemption
        idiom) so greedy re-prefill reproduces the stream token-exactly;
        the original arrival stamp is untouched."""
        cl = self.cluster
        cl._mig_ledger.release(r.rid)
        if cl.prefix_index is not None:
            cl.prefix_index.release(r.rid)
        if r.prompt is not None and r.generated:
            r.prompt = np.concatenate([
                np.asarray(r.prompt, np.int32),
                np.asarray(r.generated, np.int32),
            ])
        r.prefill_progress = 0
        r.slot = None
        r.prefill_worker = None
        r.decode_worker = None
        r.migrating = False
        r.migrate_ready = None
        r.kv_payload = None
        r.state = RequestState.PREEMPTED
        self._progress.pop(r.rid, None)
        self._attempts.pop(r.rid, None)

    def _requeue_or_shed(self, r: Request, now: float, *, reason: str,
                         fault_t: float) -> bool:
        """Re-admit ``r`` through the policy (True) or shed it as
        FAILED (False), SLO-aware either way."""
        cl = self.cluster
        self._reset_for_requeue(r)
        if not self.enabled:
            self._shed(r, now, f"{reason} (recovery disabled)")
            return False
        degraded = False
        if cl.cfg.backend == "engine":
            probe = next((w for w in cl.workers
                          if getattr(w, "engine", None) is not None),
                         None)
            if probe is not None:
                try:
                    probe.engine.validate(r)
                except ValueError:
                    # the folded prompt + remaining budget can never
                    # fit any replica of this config
                    self._shed(r, now, f"{reason}: re-prefill cannot fit")
                    return False
        verdict = cl.policy.admission_verdict(r, now)
        if not verdict.admit:
            if verdict.wid is None and cl.scaler is None:
                # no worker could ever hold it and no replacement
                # capacity is coming: lost to the fault
                self._shed(r, now, f"{reason}: {verdict.reason}")
                return False
            if verdict.wid is not None and np.isfinite(verdict.est_ttft):
                new_slo = max(r.ttft_slo,
                              verdict.est_ttft * self.cfg.degrade_factor)
                if np.isfinite(new_slo):
                    r.ttft_slo = new_slo
                    degraded = True
        cl.policy.on_request_arrive(r)
        self.n_recovered += 1
        self.recovery_latency_s += max(now - fault_t, 0.0)
        if cl.on_retried is not None:
            info = {"reason": reason}
            if degraded:
                info["degraded"] = True
                info["ttft_slo"] = round(r.ttft_slo, 4)
            cl.on_retried(r, now, info)
        return True

    def _shed(self, r: Request, now: float, reason: str) -> None:
        r.state = RequestState.FAILED
        self.n_lost += 1
        self.cluster.timeline.append(
            (now, -1, f"shed:{r.rid}:{reason}")
        )
        if self.cluster.on_failed is not None:
            self.cluster.on_failed(r, now, reason)

    # -- stuck-request scan ----------------------------------------------------
    def _scan_stuck(self, now: float) -> None:
        st = self.cfg.stuck_timeout
        cl = self.cluster
        for w in list(cl.workers):
            if not w.active or getattr(w, "crashed", False):
                continue
            for r in list(w.running) + list(w.waiting):
                prog = (r.tokens_done, r.prefill_progress)
                last = self._progress.get(r.rid)
                if last is None or last[0] != prog:
                    self._progress[r.rid] = (prog, now)
                    continue
                if now - last[1] > st:
                    w.free_kv(r)
                    if self._requeue_or_shed(r, now, reason="stuck",
                                             fault_t=last[1]):
                        cl._schedule_dispatch(now)

    # -- transfer retry --------------------------------------------------------
    def on_transfer_landed(self, r: Request) -> None:
        """A transfer landed (first try or retry): reset the retry
        budget so a later, unrelated move starts fresh."""
        self._attempts.pop(r.rid, None)

    def on_transfer_fail(self, r: Request, src_wid: int, dst_wid: int,
                         now: float, live: bool) -> None:
        """A KV transfer dropped mid-flight (its ledger charge is
        already released).  Schedule a backed-off retry, or fall back
        when retries are exhausted / recovery is off."""
        cl = self.cluster
        attempt = self._attempts.get(r.rid, 0) + 1
        self._attempts[r.rid] = attempt
        if not self.enabled or attempt > self.cfg.max_transfer_retries:
            self._transfer_fallback(r, src_wid, now, live)
            return
        if live:
            # pin against coordinator re-planning until the retry fires
            r.migrating = True
        back = min(self.cfg.retry_backoff * (2 ** (attempt - 1)),
                   self.cfg.retry_backoff_cap)
        cl._push(now + back, "kv_retry",
                 (r, src_wid, dst_wid, live, attempt))
        cl.timeline.append(
            (now, src_wid,
             f"kv_retry:{r.rid}:attempt={attempt}(+{back:.3f}s)")
        )

    def retry_transfer(self, payload, now: float) -> None:
        """Handle a ``kv_retry`` event: re-place the transfer on an
        alternate destination, or fall back."""
        cl = self.cluster
        r, src_wid, failed_dst, live, attempt = payload
        if r.state in (RequestState.FINISHED, RequestState.FAILED):
            return
        src = cl._by_wid.get(src_wid)
        if (src is None or getattr(src, "crashed", False)
                or not src.holds_kv(r)):
            # the source died or the KV moved on (crash recovery
            # already re-homed the request) — nothing left to retry
            if live:
                r.migrating = False
            return
        dst = self._pick_retry_dst(r, src_wid, failed_dst)
        if dst is None:
            self._transfer_fallback(r, src_wid, now, live)
            return
        nbytes = None
        if cl.cfg.backend == "engine":
            nbytes = cl._measured_kv_bytes(r, src_wid)
        t_x = cl.tl.kv_transfer_time(
            cl.cfg.model, r.cur_len if live else r.l_in,
            src=src_wid, dst=dst.wid, tp=cl.cfg.tp, nbytes=nbytes,
        )
        cl._mig_ledger.reserve(dst.wid, r)
        r.migrating = live
        r.decode_worker = dst.wid
        r.migrate_ready = now + t_x
        self.n_transfer_retries += 1
        cl._push(now + t_x, "kv_ready", (r, dst.wid, src_wid))
        cl.timeline.append(
            (now, src_wid, f"kv_retry_to:{r.rid}->{dst.wid}")
        )
        if cl.on_retried is not None:
            cl.on_retried(r, now, {"reason": "kv_drop",
                                   "attempt": attempt,
                                   "dst": dst.wid})

    def _pick_retry_dst(self, r: Request, src_wid: int,
                        failed_dst: int):
        """Least-loaded admissible destination, preferring anything
        other than the one that just failed (same admission math as the
        Migrator: predicted merged-batch step within the tightest TPOT,
        KV fits, reservations charged)."""
        cl = self.cluster
        cands = [w for w in cl.workers
                 if w.active and not w.evacuating
                 and not getattr(w, "crashed", False)
                 and w.wid != src_wid
                 and w.role in ("decode", "collocated")
                 and self._dest_ok(r, w)]
        if not cands:
            return None
        return min(cands, key=lambda w: (w.wid == failed_dst,
                                         cl.load_calc.load(w), w.wid))

    def _dest_ok(self, r: Request, w) -> bool:
        led = self.cluster._mig_ledger
        if (w.kv_capacity - w.kv_tokens()
                - led.tokens(w.wid)) < r.cur_len:
            return False
        lens = ([q.cur_len for q in w.running]
                + [q.cur_len for q in w.waiting]
                + led.lens(w.wid))
        e_d = self.cluster.fitted.decode_step_time(lens + [r.cur_len])
        tpots = ([q.tpot_slo for q in w.running]
                 + [q.tpot_slo for q in w.waiting]
                 + led.tpots(w.wid)
                 + [r.tpot_slo])
        return e_d <= min(tpots) * self.cfg.headroom

    def _transfer_fallback(self, r: Request, src_wid: int, now: float,
                           live: bool) -> None:
        """Retries exhausted (or no destination admits): live moves
        stay decoding on their source; a P/D hand-off re-enters the
        Migrator queue if the source survives, else re-prefills."""
        cl = self.cluster
        src = cl._by_wid.get(src_wid)
        src_alive = (src is not None and src.active
                     and not getattr(src, "crashed", False))
        r.migrating = False
        r.migrate_ready = None
        r.decode_worker = None
        self._attempts.pop(r.rid, None)
        if live and src_alive:
            # rescue abandoned: the victim never stopped decoding on
            # its source, so nothing to do beyond unpinning it
            cl.timeline.append((now, src_wid, f"kv_giveup:{r.rid}:stay"))
            return
        if not live and src_alive and src.holds_kv(r):
            if cl.migrator is not None:
                cl.migrator.on_prefill_complete(r)
                cl._schedule_migrate(now)
                cl.timeline.append(
                    (now, src_wid, f"kv_giveup:{r.rid}:requeue_pd")
                )
                return
        # source gone (or no migrator to re-place it): re-prefill
        if src is not None:
            src.free_kv(r)
        self._requeue_or_shed(r, now, reason="kv_drop", fault_t=now)
        cl._schedule_dispatch(now)
