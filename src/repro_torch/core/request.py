"""Request model and task classes (paper §3, Table 1).

A copy of ``repro/core/request.py`` (the port imports nothing from the
JAX package).  One request type serves every execution plane: the
discrete-event simulator and the real engines.  The lifecycle is

    arrival -> admitted -> prefilling(chunks) -> decoding
            -> finished | preempted(-> admitted)
    arrival -> rejected            (submit-time admission control)

tracked by :class:`RequestState`.  Scheduler-facing fields (SLOs,
priority, lengths, timing) and engine-facing fields (token ids,
generated output, slot/page bookkeeping) live side by side, so
Algorithms 1-3 operate on the same objects whether the tokens are
simulated or jitted.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class RequestState(str, enum.Enum):
    """Unified lifecycle (both planes)."""

    ARRIVED = "arrived"        # known to the control plane, not placed
    ADMITTED = "admitted"      # dispatched to a worker / engine queue
    PREFILLING = "prefilling"  # prompt tokens being consumed (chunked)
    DECODING = "decoding"      # emitting output tokens
    FINISHED = "finished"
    PREEMPTED = "preempted"    # evicted under KV pressure; re-queued
    REJECTED = "rejected"      # refused at submit time (admission control)
    FAILED = "failed"          # lost to a fault; recovery shed it


@dataclasses.dataclass
class Request:
    rid: int
    task: str = "default"
    # None = not yet released to a plane; the engine stamps submit time
    arrival: Optional[float] = None
    l_in: int = 0               # prompt length (tokens)
    l_out: int = 1              # output cap — the scheduler can't see it
    ttft_slo: float = 10.0      # seconds
    tpot_slo: float = 1.0       # seconds per output token
    priority: Optional[int] = None  # for priority-based SLO mapping

    # ---- lifecycle (filled in by the runtime) ----
    state: RequestState = RequestState.ARRIVED
    dispatch_time: Optional[float] = None
    prefill_start: Optional[float] = None
    prefill_progress: int = 0     # prompt tokens prefilled (chunked plane)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    tokens_done: int = 0
    prefill_worker: Optional[int] = None
    decode_worker: Optional[int] = None
    migrate_ready: Optional[float] = None  # KV transfer completion time
    # ---- migration (P/D hand-off and live decode-to-decode) ----
    migrating: bool = False            # a live-migration transfer in flight
    last_migrated: Optional[float] = None  # landing time (move cooldown)
    n_migrations: int = 0              # landed KV moves (hand-off + live)

    # ---- prefix cache (both planes) ----
    # workload-declared shared-prefix identity: requests with the same
    # prefix_group share their first prefix_len prompt tokens (the sim
    # plane has no token ids, so this IS the content key; the engine
    # plane materializes matching tokens from it)
    prefix_group: Optional[int] = None
    prefix_len: int = 0
    # page-aligned tokens served from the cache instead of prefilled;
    # stamped by the plane that ran (or simulated) the prefill
    prefix_hit_tokens: int = 0

    # ---- engine plane (real token ids; None on the simulator plane) ----
    # compare=False: ndarray equality is elementwise — it would make
    # the generated __eq__ raise whenever two requests tie on the
    # scalar fields (e.g. list membership tests in worker pools)
    prompt: Optional["np.ndarray"] = dataclasses.field(
        default=None, compare=False)       # (l_in,) int32 token ids
    generated: Optional[list] = dataclasses.field(
        default=None, compare=False)       # output token ids
    slot: Optional[int] = None             # engine batch row
    admit_seq: int = -1                    # submit order; preemption keeps it
    # in-flight migration payload (engine plane): set by the source's
    # export_kv when the transfer lands, consumed by accept_migrated
    kv_payload: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)

    @classmethod
    def from_prompt(cls, rid: int, prompt, max_new: int, *,
                    task: str = "engine", ttft_slo: float = 10.0,
                    tpot_slo: float = 1.0, arrival: Optional[float] = None,
                    priority: Optional[int] = None) -> "Request":
        """Build an engine-plane request from real token ids.

        ``max_new`` becomes ``l_out`` (the generation cap); ``l_in`` is
        derived from the prompt.  ``arrival=None`` lets the engine stamp
        submit time — pass an explicit arrival when a workload generator
        owns the clock.
        """
        prompt = np.asarray(prompt, np.int32)
        return cls(rid=rid, task=task, arrival=arrival,
                   l_in=int(prompt.shape[0]), l_out=int(max_new),
                   ttft_slo=ttft_slo, tpot_slo=tpot_slo, priority=priority,
                   prompt=prompt)

    @property
    def max_new(self) -> int:
        """Engine-plane alias: the generation cap is ``l_out``."""
        return self.l_out

    # -- derived metrics ----------------------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None or self.arrival is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        # engine runs may stop early (EOS/cache-full): use actual output
        n = self.tokens_done if self.tokens_done > 0 else self.l_out
        if n <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (n - 1)

    @property
    def e2e(self) -> Optional[float]:
        if self.finish_time is None or self.arrival is None:
            return None
        return self.finish_time - self.arrival

    def ttft_ok(self) -> bool:
        t = self.ttft
        return t is not None and t <= self.ttft_slo + 1e-9

    def tpot_ok(self) -> bool:
        t = self.tpot
        return t is not None and t <= self.tpot_slo + 1e-9

    def attained(self) -> bool:
        return self.ttft_ok() and self.tpot_ok()

    @property
    def cur_len(self) -> int:
        """Prefill + decoded tokens so far (l_cur in Eq. 2)."""
        return self.l_in + self.tokens_done

    def deadline(self) -> float:
        return (self.arrival or 0.0) + self.ttft_slo


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One benchmark task class (Table 1)."""

    name: str
    ttft_slo: float
    tpot_slo: float
    in_mean: float
    in_std: float
    out_mean: float
    out_std: float
    priority: int = 0

    def sample_lengths(self, rng) -> tuple[int, int]:
        l_in = max(1, int(rng.normal(self.in_mean, self.in_std)))
        l_out = max(1, int(rng.normal(self.out_mean, self.out_std)))
        return l_in, l_out


# Table 1 of the paper (SLOs in seconds; lengths mean +- std over 300 reqs)
TASKS: dict[str, TaskSpec] = {
    "medical_qa": TaskSpec("medical_qa", 0.7, 0.5, 32.57, 10.32, 38.92,
                           16.83, priority=0),
    "tldr_content_gen": TaskSpec("tldr_content_gen", 1.0, 0.7, 44.38, 6.58,
                                 96.04, 35.03, priority=1),
    "tldr_headline_gen": TaskSpec("tldr_headline_gen", 2.0, 0.9, 121.82,
                                  35.04, 13.59, 6.55, priority=2),
    "wikisql": TaskSpec("wikisql", 20.0, 1.0, 643.22, 337.01, 27.82, 4.84,
                        priority=3),
    "gsm8k": TaskSpec("gsm8k", 0.7, 0.2, 51.44, 15.78, 90.13, 26.73,
                      priority=0),
    "sharegpt": TaskSpec("sharegpt", 2.0, 0.5, 259.19, 324.88, 207.79,
                         234.99, priority=1),
}

FOUR_TASK_SET = ["medical_qa", "tldr_content_gen", "tldr_headline_gen",
                 "wikisql"]
TWO_TASK_SET = ["gsm8k", "sharegpt"]
