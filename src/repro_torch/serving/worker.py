"""Simulated worker instance (one model replica, possibly TP-sharded).

Implements the :class:`~repro_torch.serving.backend.Backend` protocol over a
discrete-event model.  Execution semantics follow the paper's
vLLM-Ascend deployment:

- a *prefill step* runs the whole waiting batch and is non-interruptible;
- *decode iterations* are interruptible: new requests join between
  iterations, finished ones leave;
- collocated workers prioritize pending prefill over the next decode
  iteration (which is why prefill stalls eat decode slack — the quantity
  Eq. 5 budgets for).

Ground-truth step durations come from an AnalyticLatencyModel with
multiplicative log-normal noise; schedulers only ever see fitted
coefficients.

A copy of ``repro/serving/worker.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.request import Request, RequestState
from repro_torch.serving.backend import StepEvents, StepOutcome, WorkerBase
from repro_torch.serving.spec_decode import (
    SpecConfig,
    expected_emitted,
    slo_spec_len,
)


class SimWorker(WorkerBase):
    def __init__(self, wid: int, role: str, truth: LatencyModel,
                 kv_capacity: int, rng: np.random.Generator,
                 noise: float = 0.02, active: bool = True,
                 chunk_tokens: Optional[int] = None,
                 prefix_index=None, spec_decode: bool = False,
                 max_spec_len: int = 8, spec_accept_rate: float = 0.7):
        super().__init__(wid, role, kv_capacity, active=active)
        self.truth = truth
        self.rng = rng
        self.noise = noise
        # speculative-decoding mirror of the engine plane: each decode
        # step widens into a propose-verify dispatch whose depth per
        # request comes from the same SLO controller the engine uses,
        # and whose emitted-token count is scaled by the modeled
        # acceptance rate — so the Dispatcher/Scaler see the same
        # acceptance-rate-scaled throughput model on both planes.
        self.spec_decode = spec_decode
        self.spec_accept_rate = spec_accept_rate
        self._spec_cfg = SpecConfig(max_spec_len=max_spec_len)
        self._spec_plan: dict[int, int] = {}    # rid -> planned depth
        # deterministic fractional-token carry per rid: acceptance is
        # modeled in expectation, no RNG, so runs replay exactly
        self._spec_carry: dict[int, float] = {}
        self.spec_dispatches = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # cluster-shared SimPrefixIndex (None = no prefix cache):
        # mirrors the engine plane's hit/miss accounting — cache-hit
        # tokens skip prefill, so step durations and Eq. 5 budgets see
        # only the uncached suffix
        self.prefix_index = prefix_index
        # chunked prefill (mirrors the engine's paged plane): each
        # prefill step consumes at most `chunk_tokens` prompt tokens and
        # alternates with a decode iteration, so long prompts don't
        # head-of-line-block in-flight decodes.  None = monolithic.
        if chunk_tokens is not None and chunk_tokens <= 0:
            raise ValueError(
                "chunk_tokens must be positive (None disables chunking); "
                "0 would spin the event loop at zero-duration steps"
            )
        self.chunk_tokens = chunk_tokens

        self.waiting: list[Request] = []   # dispatched, awaiting prefill
        self.running: list[Request] = []   # decode batch
        self.parked: list[Request] = []    # prefilled, awaiting migration
        self._turn = "prefill"     # chunked-plane round-robin fairness
        # monolithic prefill moves its batch out of `waiting` and into
        # the in-flight StepOutcome; track it so a crash teardown can
        # still re-home requests that were mid-prefill
        self._inflight_prefill: list[Request] = []

    # -- intake ---------------------------------------------------------------
    def submit(self, reqs: Sequence[Request], now: float) -> None:
        for r in reqs:
            r.state = RequestState.ADMITTED
        self.waiting.extend(reqs)

    def accept_migrated(self, r: Request, now: float) -> None:
        """A migrated request's KV landed: join the decode batch."""
        r.state = RequestState.DECODING
        self.running.append(r)

    def free_kv(self, r: Request) -> bool:
        for pool in (self.parked, self.waiting, self.running):
            if r in pool:
                pool.remove(r)
                return True
        return False

    def drop_all(self, now: float) -> list[Request]:
        """Crash teardown: every resident leaves at once (the process
        is gone); the RecoveryManager re-homes them.  Includes the
        batch inside an in-flight monolithic prefill step — its
        ``step_done`` will be discarded by the crashed guard."""
        residents = (self.waiting + self.running + self.parked
                     + self._inflight_prefill)
        self.waiting, self.running, self.parked = [], [], []
        self._inflight_prefill = []
        return residents

    def prefix_peek(self, r: Request) -> int:
        if self.prefix_index is None:
            return 0
        return self.prefix_index.peek(r)

    def _first_touch(self, r: Request, now: float) -> int:
        """Stamp prefill start and acquire the prefix-cache hit (pins
        the group until the request finishes)."""
        r.prefill_start = now
        hit = 0
        if self.prefix_index is not None:
            hit = self.prefix_index.acquire(r)
        r.prefix_hit_tokens = hit
        return hit

    # -- step selection --------------------------------------------------------
    def next_action(self) -> Optional[str]:
        """Pick the next step kind ("prefill" | "decode" | None).

        Monolithic plane: pending prefill always preempts the next
        decode iteration (the vLLM-collocated behavior Eq. 5 budgets
        for).  Chunked plane: alternate one bounded chunk with one
        decode iteration when both have work.
        """
        can_p = bool(self.waiting) and self.role in ("collocated", "prefill")
        can_d = bool(self.running) and self.role in ("collocated", "decode")
        if can_p and can_d and self.chunk_tokens is not None:
            return self._turn
        if can_p:
            return "prefill"
        return "decode" if can_d else None

    def run_step(self, now: float) -> Optional[StepOutcome]:
        kind = self.next_action()
        if kind == "prefill":
            batch, dur = self.start_prefill(now)
            return StepOutcome("prefill", dur, prefilled=batch)
        if kind == "decode":
            dur = self.start_decode(now)
            return StepOutcome("decode", dur)
        return None

    def finish_step(self, out: StepOutcome, now: float) -> StepEvents:
        # the sim plane has no real token ids: token stream events carry
        # token=None, stamped at step end by the latency model
        if out.kind == "prefill":
            self._inflight_prefill = []
            finished, parked, tokens = [], [], []
            for r in out.prefilled:
                if self.prefix_index is not None:
                    # prefill complete: the shared-prefix span is now
                    # (virtually) resident — later group-mates hit
                    self.prefix_index.publish(r)
                # a crash-recovered request re-prefills with its prior
                # progress intact: keep the original first-token stamp
                # and continue the token count instead of restarting it
                if r.first_token_time is None:
                    r.first_token_time = now
                r.tokens_done += 1
                tokens.append((r.rid, None, now))
                if r.tokens_done >= r.l_out:
                    r.finish_time = now
                    r.state = RequestState.FINISHED
                    finished.append(r)
                elif self.role == "prefill":
                    # P/D: decode placement is the Migrator's call
                    self.parked.append(r)
                    parked.append(r)
                else:
                    r.state = RequestState.DECODING
                    self.running.append(r)
            self._release_pins(finished)
            return StepEvents(finished, parked, tokens)
        still, finished, tokens = [], [], []
        for r in self.running:
            emit = 1
            k = self._spec_plan.get(r.rid, 0) if self.spec_decode else 0
            if k > 0:
                # expected accepted tokens accumulate in a fractional
                # carry; whole tokens emit as extra ticks this step
                self._spec_carry[r.rid] = (
                    self._spec_carry.get(r.rid, 0.0)
                    + expected_emitted(k, self.spec_accept_rate) - 1.0
                )
                extra = min(int(self._spec_carry[r.rid]),
                            max(0, r.l_out - r.tokens_done - 1))
                self._spec_carry[r.rid] -= extra
                self.spec_accepted += extra
                emit += extra
            for _ in range(emit):
                r.tokens_done += 1
                tokens.append((r.rid, None, now))
            if r.tokens_done >= r.l_out:
                r.finish_time = now
                r.state = RequestState.FINISHED
                finished.append(r)
                self._spec_carry.pop(r.rid, None)
            else:
                still.append(r)
        self.running = still
        self._release_pins(finished)
        return StepEvents(finished, [], tokens)

    def _release_pins(self, finished: Sequence[Request]) -> None:
        """Unpin finished requests' prefix groups.  The index is
        cluster-shared, so this works on whichever worker finishes the
        request — including after a P/D migration."""
        if self.prefix_index is None:
            return
        for r in finished:
            self.prefix_index.release(r.rid)

    # -- execution ------------------------------------------------------------
    def _noisy(self, t: float) -> float:
        if self.noise <= 0:
            return t
        return float(t * self.rng.lognormal(0.0, self.noise))

    def start_prefill(self, now: float) -> tuple[list[Request], float]:
        """Run one prefill step; returns (completed requests, duration).

        Monolithic: the whole waiting batch, non-interruptible.
        Chunked: consume at most `chunk_tokens` prompt tokens from the
        head of the queue; requests whose prompt is fully consumed
        complete (first token at step end), the rest stay waiting with
        their progress recorded.
        """
        self._turn = "decode"
        if self.chunk_tokens is None:
            batch = self.waiting
            self.waiting = []
            self._inflight_prefill = batch
            eff_lens: list[int] = []
            for r in batch:
                hit = self._first_touch(r, now)
                r.prefill_progress = r.l_in
                r.state = RequestState.PREFILLING
                # the cache-hit span skips prefill compute; >= 1 token
                # always prefills (first-token logits)
                eff_lens.append(max(1, r.l_in - hit))
            dur = self._noisy(self.truth.prefill_time(eff_lens))
            self.busy_until = now + dur
            self.busy_time += dur
            return batch, dur

        budget = self.chunk_tokens
        done: list[Request] = []
        chunk_lens: list[int] = []
        for r in list(self.waiting):
            if budget <= 0:
                break
            if r.state != RequestState.PREFILLING:
                # first touch: progress starts at the hit offset, the
                # chunk-continuation path the chunked plane already runs
                r.prefill_progress = min(self._first_touch(r, now),
                                         max(r.l_in - 1, 0))
            take = min(r.l_in - r.prefill_progress, budget)
            r.prefill_progress += take
            r.state = RequestState.PREFILLING
            budget -= take
            chunk_lens.append(take)
            if r.prefill_progress >= r.l_in:
                self.waiting.remove(r)
                done.append(r)
        # completed-this-chunk requests left `waiting` but only land in
        # running/parked at step end — crash teardown must see them
        self._inflight_prefill = done
        dur = self._noisy(self.truth.prefill_time(chunk_lens))
        self.busy_until = now + dur
        self.busy_time += dur
        return done, dur

    def start_decode(self, now: float) -> float:
        self._turn = "prefill"
        cur = [r.cur_len for r in self.running]
        n_spec = 0
        if self.spec_decode:
            # plan per-request depth with the same SLO controller the
            # engine runs; the verify lanes widen this step's duration
            self._spec_plan = {}
            for r in self.running:
                k = min(
                    slo_spec_len(r.tpot_slo, self.truth, cur,
                                 self._spec_cfg),
                    max(0, r.l_out - r.tokens_done - 1),
                )
                self._spec_plan[r.rid] = k
                n_spec += k
            if n_spec:
                self.spec_dispatches += 1
                self.spec_proposed += n_spec
        dur = self._noisy(self.truth.spec_step_time(cur, n_spec)
                          if n_spec else self.truth.decode_step_time(cur))
        self.busy_until = now + dur
        self.busy_time += dur
        return dur
