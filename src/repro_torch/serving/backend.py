"""Backend protocol: the control plane <-> execution plane contract.

The HFX control plane (Dispatcher/Algorithm 1, Migrator, Monitor,
Scaler/Algorithm 3, PrioritySLOMapper/Algorithm 2) never talks to an
execution engine directly — it talks to a :class:`Backend`: a worker
that accepts dispatched :class:`~repro_torch.core.request.Request` objects,
runs bounded steps (one prefill chunk or one decode iteration), and
reports telemetry via :class:`~repro_torch.core.monitor.WorkerSnapshot`.

Two implementations share the contract:

- :class:`~repro_torch.serving.worker.SimWorker` — discrete-event simulation;
  step durations come from an analytic roofline latency model.
- :class:`EngineWorker` (here) — wraps a real
  :class:`~repro_torch.serving.engine.InferenceEngine`; steps run actual
  jitted model compute, and the *measured* wall time of each step
  becomes the event duration, so the cluster's virtual clock advances
  by real latencies and the engine's profiler grounds the dispatcher's
  Eq. 5 budgets.

The step contract is two-phase so the event loop can schedule the
completion at ``now + duration``:

    outcome = worker.run_step(now)          # pick + start (or execute)
    ...at now + outcome.duration...
    events = worker.finish_step(outcome, t) # apply token/time bookkeeping

``run_step`` returns ``None`` when the worker has nothing to do.

A copy of ``repro/serving/backend.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence, runtime_checkable

from repro_torch.core.monitor import WorkerSnapshot
from repro_torch.core.request import Request, RequestState


@dataclasses.dataclass
class StepOutcome:
    """One started (sim) or executed (engine) worker step.

    A decode step may be a fused multi-token *block* (engine plane):
    ``info`` then carries ``k`` (fused iterations) and ``tokens``
    (tokens actually emitted), ``duration`` spans the whole block, and
    per-request TTFT/TPOT stamps are interpolated inside it by the
    engine — so control-plane accounting needs no per-token events.
    """

    kind: str                  # "prefill" | "decode"
    duration: float            # seconds of (virtual or measured) time
    # requests whose prefill completed during this step
    prefilled: list = dataclasses.field(default_factory=list)
    # requests that finished during this step (engine plane fills this
    # during run_step; the sim plane derives it in finish_step)
    finished: list = dataclasses.field(default_factory=list)
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StepEvents:
    """What ``finish_step`` reports back to the control loop."""

    finished: list             # completed at step end
    parked: list               # prefilled, awaiting migration (P/D)
    # per-token stream: (rid, token_id | None, t_emit) for every token
    # this step produced, in emission order per request.  The engine
    # fills real token ids with per-lane interpolated stamps from the
    # fused decode block (no extra host syncs — the block's single
    # sync already brought the (n_slots, K) token matrix over); the
    # simulator emits id-less ticks timed by the latency model.
    tokens: list = dataclasses.field(default_factory=list)


@runtime_checkable
class Backend(Protocol):
    """Structural interface both execution planes implement."""

    wid: int
    role: str                  # "collocated" | "prefill" | "decode" | "warm"
    active: bool
    busy_until: float
    step_pending: bool
    kv_capacity: int
    evacuating: bool           # being emptied for a flip/scale-in
    crashed: bool              # process died (fault injection)

    def submit(self, reqs: Sequence[Request], now: float) -> None: ...
    def drop_all(self, now: float) -> list: ...
    def accept_migrated(self, r: Request, now: float) -> None: ...
    def export_kv(self, r: Request): ...
    def holds_kv(self, r: Request) -> bool: ...
    def kv_payload_bytes(self, r: Request) -> Optional[float]: ...
    def run_step(self, now: float) -> Optional[StepOutcome]: ...
    def finish_step(self, out: StepOutcome, now: float) -> StepEvents: ...
    def kv_tokens(self) -> int: ...
    def prefix_peek(self, r: Request) -> int: ...
    def free_kv(self, r: Request) -> bool: ...
    def is_drained(self) -> bool: ...
    def snapshot(self, now: float, utilization: float) -> WorkerSnapshot: ...
    def has_work(self) -> bool: ...
    def is_busy(self, now: float) -> bool: ...
    def activate(self, now: float, role: Optional[str] = None) -> None: ...
    def deactivate(self, now: float) -> None: ...
    def total_up_time(self, end: float) -> float: ...


class WorkerBase:
    """Shared lifecycle/telemetry plumbing for both planes.

    Subclasses provide ``waiting`` / ``running`` / ``parked`` views
    (lists of Request) plus the step methods of the protocol.
    """

    def __init__(self, wid: int, role: str, kv_capacity: int,
                 active: bool = True):
        self.wid = wid
        self.role = role
        self.kv_capacity = kv_capacity
        self.active = active
        self.busy_until = 0.0
        self.busy_time = 0.0
        self.up_since: Optional[float] = 0.0 if active else None
        self.up_time = 0.0
        self.step_pending = False  # a worker_step event is in flight
        # live migration: the cluster is emptying this worker for a
        # pending role flip / scale-in — no new placements, no new
        # migration destinations; cleared when the action commits
        self.evacuating = False
        # fault injection: the replica process died — its in-flight
        # step results are dropped and the RecoveryManager re-homes
        # its residents on the next watchdog pass
        self.crashed = False

    # -- state ---------------------------------------------------------------
    def kv_tokens(self) -> int:
        return (sum(r.cur_len for r in self.running)
                + sum(r.l_in for r in self.waiting)
                + sum(r.cur_len for r in self.parked))

    def is_busy(self, now: float) -> bool:
        return self.busy_until > now or bool(self.waiting or self.running)

    def is_drained(self) -> bool:
        """True when this worker can safely flip roles or scale in: no
        queued or running work AND no parked KV awaiting migration
        (dropping a prefill worker that still holds exported-pending
        pages would strand them).  Load-bearing for the Scaler's
        flip/scale-in candidate choice and the Cluster's role-flip
        commit re-check."""
        return (self.active and not self.waiting and not self.running
                and not self.parked)

    def has_work(self) -> bool:
        if self.role == "prefill":
            return bool(self.waiting)
        if self.role == "decode":
            return bool(self.running)
        return bool(self.waiting or self.running)

    def free_kv(self, r: Request) -> bool:
        return False

    def prefix_peek(self, r: Request) -> int:
        """Prefix-cache hit (tokens) ``r`` would get if prefilled on
        this worker now; 0 when the plane has no prefix cache.  The
        Dispatcher charges only the uncached suffix against Eq. 5."""
        return 0

    def export_kv(self, r: Request):
        """Materialize ``r``'s KV for a hand-off; None when the plane
        has nothing physical to move (the simulator's caches are
        implicit — transfer time alone models the move)."""
        return None

    def holds_kv(self, r: Request) -> bool:
        """True while ``r``'s KV is still resident here in an
        exportable state.  The source-side guard a pending migration
        checks when its transfer lands: the request may have finished
        or been recompute-preempted during the flight, in which case
        there is nothing left to move."""
        return r in self.running or r in self.parked

    def kv_payload_bytes(self, r: Request) -> Optional[float]:
        """Measured size of the KV state a migration would move; None
        when only the analytic per-token estimate exists."""
        return None

    def accept_migrated(self, r: Request, now: float) -> None:
        """A migrated request's KV landed on this worker (P/D decode
        placement).  Planes that can't receive foreign KV must say so
        loudly rather than silently dropping the request."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot accept migrated KV"
        )

    def snapshot(self, now: float, utilization: float) -> WorkerSnapshot:
        waiting = list(self.waiting)
        running = list(self.running)
        return WorkerSnapshot(
            wid=self.wid,
            role=self.role,
            time=now,
            busy=self.is_busy(now),
            n_waiting=len(waiting),
            n_running=len(running),
            kv_tokens=self.kv_tokens(),
            cur_lens=tuple(r.cur_len for r in running),
            waiting_tokens=sum(r.l_in for r in waiting),
            utilization=utilization,
        )

    # -- lifecycle ------------------------------------------------------------
    def activate(self, now: float, role: Optional[str] = None) -> None:
        self.active = True
        if role:
            self.role = role
        if self.up_since is None:
            self.up_since = now

    def deactivate(self, now: float) -> None:
        self.active = False
        if self.up_since is not None:
            self.up_time += now - self.up_since
            self.up_since = None

    def total_up_time(self, end: float) -> float:
        t = self.up_time
        if self.up_since is not None:
            t += end - self.up_since
        return t


class EngineWorker(WorkerBase):
    """Backend over a real :class:`InferenceEngine`.

    The cluster's control plane drives jitted model compute: each
    ``run_step`` executes one engine step (prefill chunk or decode
    iteration) immediately, and the measured wall time becomes the
    event duration, so cluster virtual time tracks real latencies.
    The engine's clock is re-synced to cluster time before every step,
    which makes the engine's own first-token / finish stamps land in
    cluster time with no translation layer.

    The wrapped engine's ``profiler`` is (by construction in
    ``Cluster``) the same :class:`FittedLatencyModel` instance the
    Dispatcher budgets with — the paper's Appendix-A profiler path,
    fed by real step times.

    P/D roles run on the engine's paged plane: a ``role="prefill"``
    engine parks prefill-complete requests (KV resident, no decode)
    until the Migrator places them; ``export_kv`` materializes the
    pages + generation state and ``accept_migrated`` installs them on
    the decode engine, which continues the stream token-identically.
    """

    def __init__(self, wid: int, role: str, engine, active: bool = True):
        self.engine = engine  # before super(): the role setter syncs it
        super().__init__(wid, role, kv_capacity=engine.kv_token_capacity(),
                         active=active)
        # the engine executes steps eagerly in run_step, so a request
        # can complete (and leave every engine pool) while its step is
        # still in flight in cluster time; track those until the step's
        # events surface, or a crash teardown would strand them
        self._inflight_done: list[Request] = []

    # -- role (drives the engine's park-on-prefill behavior) -------------------
    @property
    def role(self) -> str:
        return self._role

    @role.setter
    def role(self, value: str) -> None:
        if value in ("prefill", "decode") and not self.engine.paged:
            raise ValueError(
                f"P/D roles need the engine's paged plane (worker "
                f"{self.wid} runs the slot fallback); use collocated"
            )
        self._role = value
        self.engine.park_on_prefill = (value == "prefill")

    # -- views over engine state ----------------------------------------------
    @property
    def waiting(self) -> list[Request]:
        e = self.engine
        return list(e.queue) + list(e.prefilling.values())

    @property
    def running(self) -> list[Request]:
        return list(self.engine.active.values())

    @property
    def parked(self) -> list[Request]:
        return list(self.engine.parked.values())

    def kv_tokens(self) -> int:
        e = self.engine
        resident = sum(int(e.pos[s]) for s in e.active)
        resident += sum(int(e.pos[s]) for s in e.parked)
        resident += sum(r.prefill_progress for r in e.prefilling.values())
        # queued prompts are committed budget, mirroring SimWorker
        resident += sum(len(r.prompt) for r in e.queue)
        return resident

    def has_work(self) -> bool:
        # unlike the sim plane, an engine progresses whatever it holds
        # regardless of role (e.g. a decode engine re-prefills its own
        # recompute-preempted requests); roles only steer *placement*
        e = self.engine
        return bool(e.queue or e.prefilling or e.active)

    # -- intake ----------------------------------------------------------------
    def submit(self, reqs: Sequence[Request], now: float) -> None:
        e = self.engine
        e.clock = max(e.clock, now)
        for r in reqs:
            if r.prompt is None:
                raise ValueError(
                    f"request {r.rid} has no token ids; materialize "
                    f"prompts before dispatching to the engine plane"
                )
            e.submit(r)

    # -- step contract ---------------------------------------------------------
    def run_step(self, now: float) -> Optional[StepOutcome]:
        e = self.engine
        e.clock = now
        n_fin = len(e.finished)
        n_parked = len(e.parked)
        info = e.step()
        if info.get("kind") in (None, "idle"):
            return None
        dur = float(info.get("time", 0.0))
        kind = "prefill" if info["kind"].startswith("prefill") else "decode"
        out = StepOutcome(kind=kind, duration=dur, info=info)
        out.finished = list(e.finished[n_fin:])
        self._inflight_done = list(out.finished)
        # requests parked during this step (prefill-role engines) —
        # steps only ever append to `parked`, so the tail is exact
        out.info["parked_now"] = list(e.parked.values())[n_parked:]
        self.busy_until = now + dur
        self.busy_time += dur
        return out

    def finish_step(self, out: StepOutcome, now: float) -> StepEvents:
        # compute (and its request bookkeeping) already happened in
        # run_step at engine level; just report the events
        self._inflight_done = []
        return StepEvents(finished=list(out.finished),
                          parked=out.info.pop("parked_now", []),
                          tokens=out.info.pop("token_events", []))

    def prefix_peek(self, r: Request) -> int:
        return self.engine.peek_prefix(r.prompt)

    # -- P/D hand-off ----------------------------------------------------------
    def export_kv(self, r: Request):
        return self.engine.export_kv(r.rid)

    def holds_kv(self, r: Request) -> bool:
        return self.engine.exportable(r.rid)

    def kv_payload_bytes(self, r: Request) -> Optional[float]:
        return self.engine.kv_bytes_of(r.rid)

    def accept_migrated(self, r: Request, now: float) -> None:
        e = self.engine
        e.clock = max(e.clock, now)
        payload, r.kv_payload = r.kv_payload, None
        if payload is None:
            raise ValueError(
                f"request {r.rid} arrived at worker {self.wid} without "
                f"a KV payload; engine-plane migration requires "
                f"export_kv at the source"
            )
        while not e.import_kv(payload, r):
            # destination momentarily full: recompute-preempt the
            # youngest resident (validate() guarantees any single
            # request fits alone, so this terminates)
            if not e._preempt_youngest(exclude=-1):
                raise RuntimeError(
                    f"worker {self.wid} cannot place migrated request "
                    f"{r.rid}: no slot/pages and nothing preemptible"
                )

    def free_kv(self, r: Request) -> bool:
        e = self.engine
        if r.slot is not None and (r in e.active.values()
                                   or r in e.prefilling.values()
                                   or r in e.parked.values()):
            e.evict(r.slot)
            return True
        if r in e.queue:
            e.queue.remove(r)
            return True
        return False

    def drop_all(self, now: float) -> list[Request]:
        """Crash teardown: evict every resident (queued, prefilling,
        decoding, parked) and return them for re-homing.  Leaves the
        engine fully empty so ``release_weights`` succeeds."""
        e = self.engine
        residents = (list(e.queue) + list(e.prefilling.values())
                     + list(e.active.values()) + list(e.parked.values()))
        for s in list(e.prefilling):
            e.evict(s)
        for s in list(e.active):
            e.evict(s)
        for s in list(e.parked):
            e.evict(s)
        e.queue.clear()
        # requests that completed inside the still-in-flight step: the
        # step died with the process, so in cluster time those
        # completions never happened — revert them and hand them to
        # recovery with everything else
        for r in self._inflight_done:
            r.state = RequestState.PREEMPTED
            r.finish_time = None
        residents += self._inflight_done
        self._inflight_done = []
        return residents
