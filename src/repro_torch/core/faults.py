"""Deterministic fault injection for the serving plane.

Production serving lives or dies on how it handles replicas dying,
transfers dropping, and provisioning paths failing — none of which can
be *tested* unless every failure scenario is deterministic and
replayable.  :class:`FaultInjector` is a seeded, scriptable schedule of
faults the Cluster event loop consults at well-defined points:

- ``replica_crash(wid, t)`` — the replica's process dies at virtual
  time ``t``: it stops stepping immediately; the health watchdog
  (monitor cadence) detects the corpse and runs recovery.
- ``kv_transfer_drop(p)`` — each landing KV transfer (P/D hand-off or
  live decode-to-decode migration) is dropped with probability ``p``
  from a seeded stream, bounded by an optional injection ``max``.
- ``weight_load_fail(strategy, p)`` — a weight-provisioning attempt
  through ``strategy`` fails with probability ``p``; the cluster falls
  back along d2d -> cpu -> disk.
- ``straggler(wid, slowdown)`` — every step on ``wid`` takes
  ``slowdown``x its measured/modelled duration (optionally windowed
  ``[t, until)``), the grey-failure mode that never trips a crash
  detector.

The compact spec format (``serve --fault-schedule``) is
semicolon-separated entries of ``kind:key=value,...``::

    crash:wid=1,t=2.0;kv_drop:p=0.5,max=3;weight_fail:strategy=d2d,p=1.0
    straggler:wid=0,slowdown=4.0,t=1.0,until=6.0

Same seed + same event order -> identical fault decisions, so any
failure run replays bit-for-bit.

A copy of ``repro/core/faults.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CrashEntry:
    wid: int
    t: float


@dataclasses.dataclass(frozen=True)
class StragglerEntry:
    wid: int
    slowdown: float
    t: float = 0.0
    until: float = math.inf


@dataclasses.dataclass
class FaultRecord:
    """One injected fault (the replayable audit log)."""

    t: float
    kind: str       # "crash" | "kv_drop" | "weight_fail" | "straggler"
    detail: str

    def __str__(self) -> str:  # timeline-friendly
        return f"{self.kind}:{self.detail}@{self.t:.3f}"


class FaultInjector:
    """Scriptable, seeded fault schedule consulted by the Cluster."""

    def __init__(self, *, crashes=(), kv_drop_p: float = 0.0,
                 kv_drop_max: Optional[int] = None,
                 weight_fail_p: Optional[dict] = None,
                 stragglers=(), seed: int = 0):
        self.crashes: list[CrashEntry] = [
            c if isinstance(c, CrashEntry) else CrashEntry(*c)
            for c in crashes
        ]
        if not 0.0 <= kv_drop_p <= 1.0:
            raise ValueError(f"kv_drop_p={kv_drop_p} not in [0, 1]")
        self.kv_drop_p = kv_drop_p
        self.kv_drop_max = kv_drop_max
        # strategy -> failure probability ("*" applies to any strategy)
        self.weight_fail_p: dict[str, float] = dict(weight_fail_p or {})
        for s, p in self.weight_fail_p.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"weight_fail[{s}]={p} not in [0, 1]")
        self.stragglers: list[StragglerEntry] = [
            s if isinstance(s, StragglerEntry) else StragglerEntry(*s)
            for s in stragglers
        ]
        # independent seeded streams per fault class: injecting one
        # class never perturbs another class's decisions, so adding a
        # crash to a schedule does not reshuffle which transfers drop
        self._rng_kv = np.random.default_rng(seed)
        self._rng_weight = np.random.default_rng(seed + 1)
        self.log: list[FaultRecord] = []
        self._n_kv_dropped = 0
        self._noted_stragglers: set[int] = set()

    # -- spec parsing ---------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        """Parse the ``--fault-schedule`` string format (see module
        docstring).  Unknown entry kinds or malformed fields raise —
        a typo'd fault schedule must fail loudly, not silently run a
        fault-free benchmark."""
        crashes: list[CrashEntry] = []
        stragglers: list[StragglerEntry] = []
        kv_drop_p, kv_drop_max = 0.0, None
        weight_fail: dict[str, float] = {}
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            kind, _, body = raw.partition(":")
            kind = kind.strip()
            kv: dict[str, str] = {}
            for pair in body.split(","):
                pair = pair.strip()
                if not pair:
                    continue
                k, sep, v = pair.partition("=")
                if not sep:
                    raise ValueError(
                        f"fault entry {raw!r}: expected key=value, "
                        f"got {pair!r}"
                    )
                kv[k.strip()] = v.strip()
            try:
                if kind == "crash":
                    crashes.append(CrashEntry(wid=int(kv["wid"]),
                                              t=float(kv["t"])))
                elif kind == "kv_drop":
                    kv_drop_p = float(kv["p"])
                    if "max" in kv:
                        kv_drop_max = int(kv["max"])
                elif kind == "weight_fail":
                    weight_fail[kv.get("strategy", "*")] = float(kv["p"])
                elif kind == "straggler":
                    stragglers.append(StragglerEntry(
                        wid=int(kv["wid"]),
                        slowdown=float(kv["slowdown"]),
                        t=float(kv.get("t", 0.0)),
                        until=float(kv.get("until", math.inf)),
                    ))
                else:
                    raise ValueError(
                        f"unknown fault kind {kind!r} (have: crash, "
                        f"kv_drop, weight_fail, straggler)"
                    )
            except KeyError as e:
                raise ValueError(
                    f"fault entry {raw!r} is missing field {e}"
                ) from None
        return cls(crashes=crashes, kv_drop_p=kv_drop_p,
                   kv_drop_max=kv_drop_max, weight_fail_p=weight_fail,
                   stragglers=stragglers, seed=seed)

    # -- queries (the Cluster's consultation points) ---------------------------
    def note(self, t: float, kind: str, detail: str) -> None:
        self.log.append(FaultRecord(t=t, kind=kind, detail=detail))

    @property
    def n_injected(self) -> int:
        return len(self.log)

    def drop_kv_transfer(self, now: float, rid: int,
                         src: int, dst: int) -> bool:
        """One seeded Bernoulli draw per landing transfer; records the
        injection when it fires."""
        if self.kv_drop_p <= 0.0:
            return False
        if (self.kv_drop_max is not None
                and self._n_kv_dropped >= self.kv_drop_max):
            return False
        if float(self._rng_kv.random()) >= self.kv_drop_p:
            return False
        self._n_kv_dropped += 1
        self.note(now, "kv_drop", f"rid={rid}:{src}->{dst}")
        return True

    def fail_weight_load(self, now: float, strategy: str) -> bool:
        p = self.weight_fail_p.get(strategy,
                                   self.weight_fail_p.get("*", 0.0))
        if p <= 0.0 or float(self._rng_weight.random()) >= p:
            return False
        self.note(now, "weight_fail", strategy)
        return True

    def slowdown(self, wid: int, now: float) -> float:
        """Step-duration multiplier for ``wid`` at ``now`` (>= 1.0;
        overlapping straggler windows compound)."""
        f = 1.0
        for i, s in enumerate(self.stragglers):
            if s.wid == wid and s.t <= now < s.until:
                f *= max(s.slowdown, 1.0)
                if i not in self._noted_stragglers:
                    # logged once per entry, at first application
                    self._noted_stragglers.add(i)
                    self.note(now, "straggler",
                              f"wid={s.wid}:x{s.slowdown:g}")
        return f

    def has_stragglers(self) -> bool:
        return bool(self.stragglers)
