"""Unified per-instance load signal (Llumnix-style global scheduling).

One scalar per worker, computed from the same observable surface every
control-plane component already reads — KV occupancy, queue depth,
predicted next-step time vs. the batch's tightest TPOT, and SLO-miss
risk under the fitted latency model — so the Dispatcher (placement
tie-break), the MigrationCoordinator (victim/destination pairing), and
the Scaler (scale-in / role-flip target choice) all rank instances by
the SAME definition of "loaded".  Divergent per-component heuristics
are how dispatch fills the worker migration is trying to empty.

The :class:`ReservationLedger` closes the in-flight-migration blind
spot: a request whose KV transfer has been *scheduled* but has not yet
landed via ``accept_migrated`` is invisible in the destination's
``running``/``waiting`` views, so anything reading only those views
overcommits the destination between ``kv_ready`` events.  Every
migration (P/D hand-off or live decode-to-decode) reserves its tokens
and TPOT on the destination at planning time; the Cluster releases the
reservation when the transfer resolves — landed, aborted, or
destination vanished.

A copy of ``repro/core/instance_load.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.request import Request


class ReservationLedger:
    """Per-destination accounting of migrations in flight."""

    def __init__(self):
        # dst wid -> {rid: (reserved tokens, tpot_slo)}
        self._by_dst: dict[int, dict[int, tuple[int, float]]] = {}
        self._dst_of: dict[int, int] = {}

    def reserve(self, dst: int, r: Request) -> None:
        """Charge ``r`` against ``dst`` until its transfer resolves.
        Re-reserving an rid moves the charge (a re-planned migration
        never double-counts)."""
        self.release(r.rid)
        self._by_dst.setdefault(dst, {})[r.rid] = (r.cur_len, r.tpot_slo)
        self._dst_of[r.rid] = dst

    def release(self, rid: int) -> Optional[int]:
        """Drop ``rid``'s reservation; returns the destination wid it
        was charged to (None if it held none) — idempotent, so every
        ``kv_ready`` path may call it unconditionally."""
        dst = self._dst_of.pop(rid, None)
        if dst is not None:
            slots = self._by_dst.get(dst)
            if slots is not None:
                slots.pop(rid, None)
        return dst

    def dst_of(self, rid: int) -> Optional[int]:
        return self._dst_of.get(rid)

    def drop_dst(self, dst: int) -> list[int]:
        """Clear every charge against a vanished destination (replica
        crash): those transfers can never land, and a dead worker must
        stop reserving capacity in the load signal.  Returns the rids
        released — their eventual ``kv_ready`` events then no-op."""
        rids = list(self._by_dst.pop(dst, {}))
        for rid in rids:
            self._dst_of.pop(rid, None)
        return rids

    def lens(self, dst: int) -> list[int]:
        return [tok for tok, _ in self._by_dst.get(dst, {}).values()]

    def tpots(self, dst: int) -> list[float]:
        return [tp for _, tp in self._by_dst.get(dst, {}).values()]

    def tokens(self, dst: int) -> int:
        return sum(tok for tok, _ in self._by_dst.get(dst, {}).values())

    def n_inflight(self, dst: int) -> int:
        return len(self._by_dst.get(dst, {}))


@dataclasses.dataclass
class InstanceLoadConfig:
    headroom: float = 0.95    # fraction of the tightest TPOT E_d may use
    w_kv: float = 1.0         # KV occupancy weight
    w_queue: float = 0.4      # waiting-queue depth weight
    w_pressure: float = 1.0   # predicted decode pressure weight
    w_risk: float = 0.5       # SLO-miss-risk weight
    pressure_cap: float = 2.0 # saturate so one hot replica can't hide
                              # ordering among the others


class InstanceLoadCalculator:
    """One load scalar per Backend worker, reservation-aware."""

    def __init__(self, latency_model: LatencyModel,
                 cfg: Optional[InstanceLoadConfig] = None,
                 ledger: Optional[ReservationLedger] = None):
        self.model = latency_model
        self.cfg = InstanceLoadConfig() if cfg is None else cfg
        self.ledger = ledger if ledger is not None else ReservationLedger()

    # -- components --------------------------------------------------------------
    def decode_lens(self, w) -> list[int]:
        """Context lengths the next decode step would batch, including
        reserved in-flight arrivals."""
        return ([r.cur_len for r in w.running]
                + self.ledger.lens(w.wid))

    def decode_tpots(self, w) -> list[float]:
        return ([r.tpot_slo for r in w.running]
                + self.ledger.tpots(w.wid))

    def kv_occupancy(self, w) -> float:
        used = w.kv_tokens() + self.ledger.tokens(w.wid)
        return used / max(w.kv_capacity, 1)

    def pressure(self, w) -> float:
        """Predicted next decode-step time over the tightest TPOT
        budget of the (running + reserved) batch; > 1 means the fitted
        model already predicts a TPOT miss on this worker."""
        lens = self.decode_lens(w)
        if not lens:
            return 0.0
        tpots = self.decode_tpots(w)
        budget = min(tpots) * self.cfg.headroom
        e_d = self.model.decode_step_time(lens)
        return e_d / max(budget, 1e-9)

    def slo_risk(self, w) -> float:
        """Fraction of the decode batch whose own TPOT budget the
        predicted next step already exceeds — pressure localizes the
        tightest request, risk says how widespread the miss is."""
        lens = self.decode_lens(w)
        if not lens:
            return 0.0
        e_d = self.model.decode_step_time(lens)
        tpots = self.decode_tpots(w)
        miss = sum(1 for tp in tpots
                   if e_d > tp * self.cfg.headroom)
        return miss / len(tpots)

    # -- the scalar --------------------------------------------------------------
    def load(self, w) -> float:
        """Weighted load in ~[0, w_kv + w_queue + w_pressure·cap + w_risk];
        monotone in every component, 0 for an idle worker."""
        c = self.cfg
        queue = len(w.waiting)
        q_term = 1.0 - 1.0 / (1.0 + queue)   # [0, 1), saturating
        p_term = min(self.pressure(w), c.pressure_cap)
        return (c.w_kv * self.kv_occupancy(w)
                + c.w_queue * q_term
                + c.w_pressure * p_term
                + c.w_risk * self.slo_risk(w))

    def rank(self, workers) -> list:
        """Active workers, least loaded first (wid tie-break)."""
        return sorted((w for w in workers if w.active),
                      key=lambda w: (self.load(w), w.wid))
