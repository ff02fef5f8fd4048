"""Online serving session: the system's front door (paper §1, §5).

HFX is a *production serving system*: requests arrive continuously,
clients stream tokens as they are generated, and the scheduler's
proactive budget estimation decides admission *at arrival time*.
:class:`ServingSession` is that front door over the existing cluster —
it owns the event loop incrementally instead of replaying a closed
world:

    session = ServingSession(Cluster(cfg), admission="reject")
    handle = session.submit(prompt, task="chat", ttft_slo=0.8,
                            tpot_slo=0.25, l_out=64)
    for ev in handle.events():       # ADMITTED, FIRST_TOKEN, TOKEN...,
        print(ev.kind, ev.time)      # FINISHED — typed + timestamped
    session.drain(); session.close()

Key properties:

- **Submit-time admission** — the dispatcher's Eq. 5 budget estimate
  (:meth:`~repro_torch.core.dispatcher.Dispatcher.admission_verdict`) is
  evaluated when ``submit`` is called.  ``admission="reject"`` refuses
  doomed requests immediately (REJECTED event, state
  ``RequestState.REJECTED``); ``admission="degrade"`` renegotiates the
  TTFT SLO to the achievable estimate and admits best-effort;
  ``admission="none"`` restores the closed-world behavior (everything
  queues).
- **Per-token streaming with no extra host syncs** — the engine's
  fused decode blocks already bring an ``(n_slots, K)`` token matrix
  over in their single sync; the session just relays each lane with
  its interpolated stamp.  The simulator streams id-less token ticks
  timed by its latency model.
- **Two clock drivers** — ``clock="virtual"`` (default) advances time
  event-to-event (deterministic; what benchmarks and tests use);
  ``clock="wall"`` paces event processing against the real clock, so
  a closed-loop client experiences live latencies.
- ``Cluster.run`` is a thin batch adapter over this class — the batch
  and online paths share one event loop by construction.

Single-threaded by design: generators returned by
:meth:`ResponseHandle.events` *drive* the loop while they wait, which
is what makes closed-loop clients work without threads.

A copy of ``repro/serving/session.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import TYPE_CHECKING, Callable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request, RequestState
from repro_torch.serving.metrics import COST_UNIT, RunMetrics, StreamingStats

if TYPE_CHECKING:
    from repro_torch.serving.cluster import Cluster, ClusterResult


class EventKind(str, enum.Enum):
    """Typed stream-event vocabulary (the JSONL ``event`` field)."""

    ADMITTED = "admitted"
    REJECTED = "rejected"
    FIRST_TOKEN = "first_token"
    TOKEN = "token"
    FINISHED = "finished"
    # fault recovery: RETRIED marks a re-queued/retried request (the
    # stream continues); FAILED is terminal — the request was lost to a
    # fault and recovery shed it, so events() always terminates
    RETRIED = "retried"
    FAILED = "failed"


@dataclasses.dataclass
class StreamEvent:
    """One timestamped occurrence on a response stream."""

    kind: EventKind
    rid: int
    time: float                 # cluster-clock seconds
    token: Optional[int] = None  # token id; None on the sim plane
    data: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = {"event": self.kind.value, "rid": self.rid,
             "t": round(self.time, 6)}
        if self.token is not None:
            d["token"] = int(self.token)
        d.update(self.data)
        return d


# event kinds whose processing constitutes forward progress on
# in-flight work — they extend the drain deadline (see drain())
_PROGRESS_KINDS = frozenset(
    {"arrival", "step_done", "kv_ready", "worker_up", "role_flip"}
)


class _WallClock:
    """Real-time driver: event times are paced against the wall."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0


class ResponseHandle:
    """Client-side view of one submitted request's event stream."""

    def __init__(self, session: "ServingSession", request: Request):
        self.session = session
        self.request = request
        self.rid = request.rid
        self._log: list[StreamEvent] = []
        self.n_tokens = 0
        self._terminal = False

    # -- state ----------------------------------------------------------------
    @property
    def done(self) -> bool:
        """Terminal: FINISHED, REJECTED or FAILED has been delivered."""
        return self._terminal

    @property
    def rejected(self) -> bool:
        return self.request.state == RequestState.REJECTED

    @property
    def failed(self) -> bool:
        """Lost to a fault (replica crash / unrecoverable transfer)."""
        return self.request.state == RequestState.FAILED

    @property
    def log(self) -> list[StreamEvent]:
        """Events delivered so far (does not advance the loop)."""
        return list(self._log)

    # -- consumption ----------------------------------------------------------
    def events(self, wait: bool = True) -> Iterator[StreamEvent]:
        """Yield this handle's events in order.  With ``wait`` (the
        default) the iterator *drives the session's event loop* until
        the stream is terminal — this is how a single-threaded
        closed-loop client blocks on its response.  ``wait=False``
        yields only what has already been delivered."""
        i = 0
        while True:
            while i < len(self._log):
                yield self._log[i]
                i += 1
            if self._terminal or not wait:
                return
            if not self.session._pump(self):
                return  # loop can make no further progress

    def result(self) -> Request:
        """Drive the loop until terminal; returns the request record
        (generated tokens, timing stamps, final state)."""
        for _ in self.events():
            pass
        return self.request

    # -- session side ---------------------------------------------------------
    def _deliver(self, ev: StreamEvent) -> None:
        self._log.append(ev)
        if ev.kind in (EventKind.FINISHED, EventKind.REJECTED,
                       EventKind.FAILED):
            self._terminal = True


class ServingSession:
    """Online front door over a :class:`~repro_torch.serving.cluster.Cluster`.

    Parameters
    ----------
    cluster:
        The cluster to serve on (either plane, any policy/mode).
    admission:
        ``"reject"`` (default) — refuse requests whose Eq. 5 verdict
        fails; ``"degrade"`` — renegotiate the TTFT SLO to the
        achievable estimate and admit; ``"none"`` — admit everything
        (closed-world behavior; what ``Cluster.run`` uses).
    clock:
        ``"virtual"`` — time advances event-to-event; ``"wall"`` —
        event processing is paced against real time.
    on_event:
        Optional callback invoked with every :class:`StreamEvent`
        across all handles (the ``serve --online`` JSONL emitter).
    degrade_factor:
        Safety stretch applied to the estimated-achievable TTFT when
        ``admission="degrade"`` renegotiates an SLO.
    """

    def __init__(self, cluster: "Cluster", *, admission: str = "reject",
                 clock: str = "virtual",
                 on_event: Optional[Callable[[StreamEvent], None]] = None,
                 degrade_factor: float = 1.25):
        if admission not in ("none", "reject", "degrade"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if clock not in ("virtual", "wall"):
            raise ValueError(f"unknown clock driver {clock!r}")
        self.cluster = cluster
        self.admission = admission
        self.degrade_factor = degrade_factor
        self.on_event = on_event
        self._wall = _WallClock() if clock == "wall" else None
        # live (non-terminal) handles only — terminal ones are dropped
        # so a long-lived session's footprint tracks in-flight work,
        # not total tokens ever streamed (clients keep their own
        # handle/log alive for exactly as long as they hold it).
        # _requests retains one small record per request for final
        # metrics; callers running unbounded sessions should window
        # via partial() + fresh sessions.
        self._handles: dict[int, ResponseHandle] = {}
        self._requests: list[Request] = []   # submit order, incl. rejected
        # every rid ever used (terminal handles leave _handles, but a
        # rid must stay unique for the session's whole lifetime — a
        # JSONL consumer attributes events by rid)
        self._used_rids: set[int] = set()
        self._inflight = 0
        self._rid_auto = itertools.count()
        # deterministic prompt synthesis for length-only submissions:
        # same rng seed + draw order as workload.materialize_prompts,
        # so online and batch runs are token-identical
        self._mat_rng = np.random.default_rng(cluster.cfg.seed)
        self._max_arrival = 0.0
        self._last_progress = 0.0
        self._closed = False
        self._result: Optional["ClusterResult"] = None
        self.streaming = StreamingStats()
        if cluster.on_token is not None or cluster.on_finish is not None:
            raise RuntimeError(
                "cluster already has (or had) a ServingSession attached; "
                "a Cluster's clock and cost accounting span one session "
                "— build a fresh Cluster per run/session"
            )
        cluster.on_token = self._on_token
        cluster.on_finish = self._on_finish
        cluster.on_failed = self._on_failed
        cluster.on_retried = self._on_retried
        cluster.start()

    # -- clock ----------------------------------------------------------------
    @property
    def now(self) -> float:
        """Current session time: the wall driver's clock, or the
        cluster's virtual clock."""
        if self._wall is not None:
            return max(self._wall.now(), self.cluster.now)
        return self.cluster.now

    # -- submission ------------------------------------------------------------
    def submit(self, prompt=None, *, task: str = "default",
               l_in: Optional[int] = None, l_out: int = 1,
               ttft_slo: float = 10.0, tpot_slo: float = 1.0,
               arrival: Optional[float] = None,
               priority: Optional[int] = None,
               rid: Optional[int] = None) -> ResponseHandle:
        """Submit one request; returns its :class:`ResponseHandle`.

        ``prompt`` is real token ids (engine plane); omit it and give
        ``l_in`` for length-only workloads (the sim plane always, the
        engine plane synthesizes deterministic ids).  ``arrival=None``
        stamps the current session time — the natural choice for
        closed-loop clients."""
        if prompt is not None:
            r = Request.from_prompt(
                -1 if rid is None else rid, prompt, max_new=l_out,
                task=task, ttft_slo=ttft_slo, tpot_slo=tpot_slo,
                arrival=arrival, priority=priority,
            )
        else:
            if l_in is None:
                raise ValueError("submit needs a prompt or l_in")
            r = Request(rid=-1 if rid is None else rid, task=task,
                        arrival=arrival, l_in=int(l_in),
                        l_out=int(l_out), ttft_slo=ttft_slo,
                        tpot_slo=tpot_slo, priority=priority)
        return self.submit_request(r)

    def submit_request(self, r: Request) -> ResponseHandle:
        """Submit a pre-built :class:`Request` (the workload-replay and
        batch-adapter path).  Performs arrival stamping, engine-plane
        prompt materialization/validation, and the admission verdict."""
        if self._closed:
            raise RuntimeError("session is closed")
        cl = self.cluster
        if r.arrival is None:
            r.arrival = self.now
        if r.rid is None or r.rid < 0:
            r.rid = self._next_rid()
        if r.rid in self._used_rids:
            raise ValueError(f"duplicate rid {r.rid}")
        self._used_rids.add(r.rid)
        self._max_arrival = max(self._max_arrival, r.arrival)
        handle = ResponseHandle(self, r)
        self._handles[r.rid] = handle
        self._requests.append(r)

        reason = None
        if cl.cfg.backend == "engine":
            if r.prompt is None:
                from repro_torch.serving.workload import materialize_prompts

                # same draw as the batch path, from one persistent rng:
                # online submits are prompt-identical to a batch
                # materialization of the same requests in the same
                # order.  `seed` keys the group-prefix streams, which
                # bypass the rng so group-mates match across planes.
                materialize_prompts([r], cl.cfg.model.vocab_size,
                                    seed=cl.cfg.seed, rng=self._mat_rng)
            try:
                cl.workers[0].engine.validate(r)
            except ValueError:
                if self.admission == "none":
                    raise
                reason = "request can never fit this engine"
        if r.generated is None:
            r.generated = []

        data: dict = {}
        if reason is None and self.admission != "none":
            verdict = cl.policy.admission_verdict(
                r, max(cl.now, r.arrival)
            )
            data = {"p": round(verdict.p, 4)}
            if np.isfinite(verdict.est_ttft):
                data["est_ttft"] = round(verdict.est_ttft, 4)
            if not verdict.admit:
                if self.admission == "degrade" and verdict.wid is not None:
                    # renegotiate: stretch the TTFT SLO to what the
                    # budget estimate says is achievable, keep serving
                    new_slo = max(
                        r.ttft_slo,
                        verdict.est_ttft * self.degrade_factor,
                    )
                    if np.isfinite(new_slo):
                        r.ttft_slo = new_slo
                    data["degraded"] = True
                    data["ttft_slo"] = round(r.ttft_slo, 4)
                else:
                    # wid=None means no worker could EVER hold the
                    # prompt — no SLO renegotiation can fix that, so
                    # degrade mode refuses too instead of queueing
                    # permanently unplaceable work
                    reason = verdict.reason
        if reason is not None:
            r.state = RequestState.REJECTED
            self._emit(handle, StreamEvent(
                EventKind.REJECTED, r.rid, r.arrival,
                data={**data, "reason": reason},
            ))
            self._handles.pop(r.rid, None)  # terminal: session-side drop
            return handle

        self._inflight += 1
        cl.enqueue(r)
        self._emit(handle, StreamEvent(
            EventKind.ADMITTED, r.rid, r.arrival, data=data,
        ))
        return handle

    def _next_rid(self) -> int:
        while True:
            rid = next(self._rid_auto)
            if rid not in self._used_rids:
                return rid

    # -- event-loop driving ----------------------------------------------------
    def _deadline(self) -> float:
        """Drain horizon: ``drain_timeout`` past the last *progress*
        (arrival, step completion, KV landing, scale-up) rather than
        the last arrival — in-flight work keeps extending it, so a
        long-decode tail request is never cut off mid-stream, while
        queued work that can never be placed still times out."""
        return (max(self._max_arrival, self._last_progress)
                + self.cluster.cfg.drain_timeout)

    def _advance(self) -> bool:
        """Process one due cluster event (wall clock: wait for it).
        Returns False when the loop can make no further progress."""
        cl = self.cluster
        t = cl.next_event_time()
        if t is None:
            return False
        if t > self._deadline():
            return False
        if self._wall is not None:
            lag = t - self._wall.now()
            if lag > 0:
                time.sleep(min(lag, 0.05))
                if t > self._wall.now():
                    return True  # waited; re-check (new submits may land)
        kind = cl.process_next()
        if kind in _PROGRESS_KINDS:
            self._last_progress = cl.now
        return True

    def _pump(self, handle: ResponseHandle) -> bool:
        """Advance the loop until ``handle`` gains events or terminates;
        False when no further progress is possible."""
        n = len(handle._log)
        while len(handle._log) == n and not handle._terminal:
            if not self._advance():
                return False
        return True

    def poll(self) -> int:
        """Process every event due *now* without blocking on future
        ones; returns the number processed.  Useful between submits in
        an open-loop replay."""
        n = 0
        cl = self.cluster
        while True:
            t = cl.next_event_time()
            if t is None or t > self.now or not self._advance():
                return n
            n += 1

    def run_until(self, t: float) -> None:
        """Advance the virtual clock through every event at or before
        ``t`` (replaying a trace with explicit arrival stamps)."""
        while True:
            nt = self.cluster.next_event_time()
            if nt is None or nt > t or not self._advance():
                return

    def drain(self) -> None:
        """Serve until every admitted request has finished (or the
        progress deadline expires for work that can never be placed)."""
        while self._inflight > 0:
            if not self._advance():
                break

    def close(self, requests: Optional[Sequence[Request]] = None
              ) -> "ClusterResult":
        """Stop accepting submissions and build the final
        :class:`ClusterResult` (idempotent)."""
        if not self._closed:
            self._closed = True
            self._result = self.cluster.collect_result(
                self._requests if requests is None else requests
            )
            # sinks stay attached: a Cluster's virtual clock and cost
            # accounting span its lifetime, so re-running one would
            # silently corrupt metrics (arrivals clamped past the old
            # makespan) — a second attach fails loudly instead; build
            # a fresh Cluster per run/session
        return self._result

    # -- incremental metrics ----------------------------------------------------
    def partial(self) -> RunMetrics:
        """Rolling metrics snapshot over everything submitted so far
        (attainment over finished-so-far; see RunMetrics.partial)."""
        cl = self.cluster
        cost = sum(
            w.total_up_time(cl.now) for w in cl.workers
        ) / COST_UNIT
        return RunMetrics.partial(self._requests, cost, cl.now)

    # -- cluster sinks -----------------------------------------------------------
    def _emit(self, handle: ResponseHandle, ev: StreamEvent) -> None:
        handle._deliver(ev)
        self.streaming.observe(ev.kind.value, ev.rid, ev.time,
                               arrival=handle.request.arrival)
        if self.on_event is not None:
            self.on_event(ev)

    def _on_token(self, rid: int, token: Optional[int],
                  t: float) -> None:
        h = self._handles.get(rid)
        if h is None:
            return
        kind = (EventKind.FIRST_TOKEN if h.n_tokens == 0
                else EventKind.TOKEN)
        h.n_tokens += 1
        self._emit(h, StreamEvent(kind, rid, t, token=token))

    def _on_finish(self, r: Request, t: float) -> None:
        self._inflight -= 1
        h = self._handles.get(r.rid)
        if h is None:
            return
        # the engine interpolates finish stamps to the emitting lane
        # inside a fused block; prefer that over the event-loop time so
        # FINISHED never precedes its own last TOKEN stamp
        t_fin = r.finish_time if r.finish_time is not None else t
        self._emit(h, StreamEvent(
            EventKind.FINISHED, r.rid, t_fin,
            data={"n_tokens": r.tokens_done, "attained": r.attained()},
        ))
        self._handles.pop(r.rid, None)  # terminal: session-side drop

    def _on_failed(self, r: Request, t: float, reason: str) -> None:
        """Recovery shed ``r``: the fault is unrecoverable, so its
        stream must terminate — a FAILED event is terminal, keeping
        every events() consumer (and drain()) from hanging."""
        self._inflight -= 1
        h = self._handles.get(r.rid)
        if h is None:
            return
        self._emit(h, StreamEvent(
            EventKind.FAILED, r.rid, t,
            data={"reason": reason, "n_tokens": r.tokens_done},
        ))
        self._handles.pop(r.rid, None)  # terminal: session-side drop

    def _on_retried(self, r: Request, t: float, info: dict) -> None:
        """Recovery re-queued ``r`` (crash re-prefill) or retried its
        KV transfer — non-terminal, the stream continues."""
        h = self._handles.get(r.rid)
        if h is None:
            return
        self._emit(h, StreamEvent(EventKind.RETRIED, r.rid, t,
                                  data=dict(info)))
