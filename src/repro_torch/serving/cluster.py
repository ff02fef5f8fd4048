"""Backend-agnostic multi-instance serving control loop.

Runs the full HyperFlexis stack — Dispatcher (Algorithm 1), Migrator,
Monitor, Scaler (Algorithm 3), TLManager, priority SLO mapping
(Algorithm 2) — or any baseline policy, over workers that implement the
:class:`~repro_torch.serving.backend.Backend` protocol.  Two planes exist:

- ``backend="sim"`` (default): :class:`SimWorker` instances whose
  ground-truth step latencies come from the analytic roofline model of
  the chosen LLM (§7.2 models).  Schedulers only observe *fitted*
  latency coefficients (Appendix A) and periodic Monitor snapshots,
  preserving the paper's information structure.
- ``backend="engine"``: :class:`EngineWorker` instances wrapping real
  :class:`InferenceEngine` replicas.  Every step runs real model
  compute; measured wall times become event durations, and the
  engines' shared profiler IS the Dispatcher's FittedLatencyModel, so
  Eq. 5 budgets are grounded in real latencies.

The same Dispatcher/Scaler/PrioritySLOMapper instances drive either
plane unmodified.  Supports collocated and P/D-disaggregated execution
on BOTH planes (engine P/D moves real paged KV: the source engine's
``export_kv`` payload is installed on the decode engine when the
TLManager-costed transfer lands), scaling with warm pool + D2D fast
weight transfer, and Fig. 6-style dynamic SLO mapping.

A copy of ``repro/serving/cluster.py`` (the port imports nothing from
the JAX package), line for line except the engine plane's set-up —
``_init_engine_plane`` and the engine branch of ``_make_worker`` — which
is rewritten for the port: each replica is its own ``Model`` holding the
tensors its transport provisioned, on the device its ``WeightManager``
places it on (round-robin over the devices the constructor resolves, as
JAX's over ``jax.devices()``: every visible card unless the caller
names a device or passes ``devices=``).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.latency_model import (
    AnalyticLatencyModel,
    FittedLatencyModel,
    Hardware,
    TPU_V5E,
)
from repro_torch.core.faults import FaultInjector
from repro_torch.core.instance_load import (
    InstanceLoadCalculator,
    ReservationLedger,
)
from repro_torch.core.migrator import (
    MigrationConfig,
    MigrationCoordinator,
    Migrator,
)
from repro_torch.core.monitor import Monitor
from repro_torch.core.policies import make_policy
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scaler import ScaleAction, Scaler, ScalerConfig
from repro_torch.core.slo_mapper import PrioritySLOMapper
from repro_torch.core.tlmanager import TLManager
from repro_torch.serving.backend import Backend, EngineWorker
from repro_torch.serving.metrics import COST_UNIT, RunMetrics, compute_metrics
from repro_torch.serving.recovery import RecoveryConfig, RecoveryManager
from repro_torch.serving.worker import SimWorker

if TYPE_CHECKING:  # engine plane imported lazily at runtime
    from repro_torch.serving.engine import EngineConfig


@dataclasses.dataclass
class ClusterConfig:
    model: ModelConfig
    n_workers: int = 2
    policy: str = "hyperflexis"
    backend: str = "sim"            # "sim" | "engine"
    # engine-plane knobs (n_slots, max_len, page_size, chunk_size, ...);
    # None = EngineConfig() defaults.  Only read when backend="engine".
    engine: Optional["EngineConfig"] = None
    mode: str = "collocated"        # "collocated" | "pd"
    n_prefill: int = 1              # pd mode initial split
    n_decode: int = 1
    scaling: bool = False
    scaler: ScalerConfig = dataclasses.field(default_factory=ScalerConfig)
    monitor_interval: float = 0.05  # Fig. 8 knob
    # chunked prefill (sim plane; the engine plane chunks natively):
    # bound on prompt tokens per prefill step, interleaved 1:1 with
    # decode iterations; None = monolithic (legacy) prefill
    chunk_tokens: Optional[int] = None
    # prefix cache: page-level KV reuse across requests.  Engine plane:
    # every replica gets a PrefixCache over its page pool (overrides
    # EngineConfig.prefix_cache); sim plane: one cluster-shared
    # SimPrefixIndex mirrors hit/miss accounting.  prefix_cache_pages
    # caps the cache footprint (pages; None = bounded by the pool).
    prefix_cache: bool = False
    prefix_cache_pages: Optional[int] = None
    # SLO-customized speculative decoding.  Engine plane: every replica
    # runs the n-gram drafter + one-dispatch verify with per-lane depth
    # from Eq. 5 / TPOT slack (overrides EngineConfig.spec_decode); sim
    # plane: decode ticks are acceptance-rate-scaled with the same
    # controller, so the Dispatcher/Scaler see one throughput model.
    spec_decode: bool = False
    max_spec_len: int = 8
    spec_accept_rate: float = 0.7   # sim-plane modeled acceptance
    # live migration: a MigrationCoordinator plans decode-to-decode
    # moves every monitor tick (rescue predicted-TPOT-miss requests,
    # rebalance bursty ramps) and the Scaler's flip / scale-in targets
    # are *evacuated* (migrate-then-flip) instead of waiting for a
    # natural drain.  ``migration`` tunes the planner; None = defaults.
    live_migration: bool = False
    migration: Optional[MigrationConfig] = None
    tp: int = 1
    hw: Hardware = TPU_V5E
    seed: int = 0
    noise: float = 0.02
    # one-shot decode assignment at arrival (the anti-pattern §5.1 fixes);
    # only meaningful with mode="pd" and baseline policies
    one_shot_pd: bool = False
    slo_mapper: Optional[PrioritySLOMapper] = None
    drain_timeout: float = 3600.0
    # fault tolerance: a seeded FaultInjector the event loop consults
    # (crashes, transfer drops, weight-load failures, stragglers) and
    # the recovery switch — recovery=False is the ablation arm where a
    # crash sheds its residents instead of re-queueing them
    faults: Optional[FaultInjector] = None
    recovery: bool = True
    recovery_cfg: Optional[RecoveryConfig] = None


@dataclasses.dataclass
class ClusterResult:
    metrics: RunMetrics
    requests: list
    timeline: list          # (time, wid, event) trace of scaling actions
    monitor: Monitor
    n_scale_out: int = 0
    n_scale_in: int = 0
    n_role_flips: int = 0
    kv_transfers: int = 0
    # engine plane only: fused-decode telemetry summed over workers —
    # block-size histogram {K: n_blocks}, decode tokens emitted, and
    # total jitted dispatches (= host syncs), the figure decode blocks
    # amortize
    decode_block_hist: dict = dataclasses.field(default_factory=dict)
    n_decode_tokens: int = 0
    n_dispatches: int = 0
    # prompt tokens that actually ran prefill compute (engine plane;
    # with a prefix cache this is the FLOPs-saved denominator's
    # complement) and per-plane prefix-cache telemetry
    n_prefill_tokens: int = 0
    prefix_stats: dict = dataclasses.field(default_factory=dict)
    # live migration telemetry: landed decode-to-decode moves, and the
    # coordinator's split of planned moves by reason
    n_live_migrations: int = 0
    n_rescues: int = 0
    n_evacuations: int = 0
    # fault tolerance: injected faults, requests re-queued/retried by
    # recovery, requests lost (FAILED), transfer retries landed, and
    # the summed fault -> re-admission latency over recovered requests
    n_faults: int = 0
    n_recovered: int = 0
    n_lost: int = 0
    n_transfer_retries: int = 0
    recovery_latency_s: float = 0.0
    # speculative decoding: propose-verify dispatches, drafted tokens
    # sent to verify, and drafted tokens accepted (both planes)
    spec_dispatches: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0


class Cluster:
    """``device``, ``devices``, ``seed_params``, ``dtype`` and
    ``ckpt_dir`` are read only on the engine plane.  ``device`` is
    resolved by :func:`repro_torch.resolve_device`: CUDA unless the
    caller names another, raising without a card.  Replicas round-robin
    over a list of devices (``WeightManager.placement``): ``devices`` if
    given (a port-only keyword; it may mix cards and the CPU), else
    every visible card for a CUDA ``device`` without an index (JAX's
    ``jax.devices()``), else ``device`` alone; the default never adds
    the CPU beside a card.  The seed's weights are drawn on the list's
    first device.  ``seed_params`` is a state dict
    in the port's names (e.g. ``convert.params_from_jax(tree, cfg)``);
    None draws one with ``models.build.seeded_model`` from ``cfg.seed``
    (other numbers than the JAX package's for the same seed).
    ``dtype`` is the weights' (default: the seed's, else f32);
    ``ckpt_dir`` holds the seed checkpoint the ``disk`` transport reads
    (default: a temporary directory)."""

    def __init__(self, cfg: ClusterConfig, *, device=None, devices=None,
                 seed_params=None, dtype=None,
                 ckpt_dir: Optional[str] = None):
        if cfg.backend not in ("sim", "engine"):
            raise ValueError(f"unknown backend {cfg.backend!r}")
        self.cfg = cfg
        # set before the initial _make_worker calls: weight-load faults
        # can fire on the very first provisioning attempts (and those
        # stamp self.now, re-zeroed with the event-loop state below)
        self.faults = cfg.faults
        self.now = 0.0
        self.rng = np.random.default_rng(cfg.seed)
        self.monitor = Monitor(cfg.monitor_interval)
        self.tl = TLManager(cfg.hw)
        # engine plane: per-replica weight ownership (set in
        # _init_engine_plane); None on the sim plane
        self.weights = None
        self._provision_s: Optional[float] = None
        self._provision_strategy: Optional[str] = None
        # sim plane: one cluster-shared prefix index (the engine plane
        # builds a per-replica PrefixCache in _make_worker instead)
        self.prefix_index = None
        if cfg.prefix_cache and cfg.backend == "sim":
            from repro_torch.serving.prefix_cache import SimPrefixIndex

            self.prefix_index = SimPrefixIndex(
                page_size=(cfg.engine.page_size if cfg.engine is not None
                           else 16),
                capacity_pages=cfg.prefix_cache_pages,
            )
        if cfg.backend == "engine":
            self._init_engine_plane(device, devices, seed_params, dtype,
                                    ckpt_dir)
        else:
            self.truth = AnalyticLatencyModel(cfg.model, cfg.hw, tp=cfg.tp)
            self.fitted = FittedLatencyModel.from_profile(
                self.truth, self.rng
            )
            self._kv_cap = self._kv_capacity()

        self.workers: list[Backend] = []
        for i, role in enumerate(self._initial_roles()):
            self.workers.append(self._make_worker(i, role))
        self._next_wid = len(self.workers)

        # one per-instance load signal (Llumnix-style) shared by the
        # Dispatcher (placement tie-break), the MigrationCoordinator
        # (victim/destination pairing), and the Scaler (target choice).
        # Its ReservationLedger charges every in-flight migration to
        # its destination, so no consumer overcommits a worker that a
        # scheduled-but-not-landed transfer is about to fill.
        self._mig_ledger = ReservationLedger()
        self.load_calc = InstanceLoadCalculator(
            self.fitted, ledger=self._mig_ledger
        )

        self.policy = make_policy(
            cfg.policy, self.fitted, self.monitor, self._do_dispatch,
            load_calc=self.load_calc,
        )
        for w in self.workers:
            if w.role in ("collocated", "prefill"):
                self.policy.add_worker(w, 0.0)

        self.migrator = None
        if cfg.mode == "pd" and not cfg.one_shot_pd:
            # engine plane: transfers are costed on the *measured*
            # payload bytes the source engine would export, not the
            # analytic per-token estimate
            measure = (self._measured_kv_bytes if cfg.backend == "engine"
                       else None)
            self.migrator = Migrator(
                self.fitted, self.monitor, self.tl, cfg.model, tp=cfg.tp,
                measure_bytes=measure, ledger=self._mig_ledger,
            )
        self.coordinator = None
        if cfg.live_migration:
            measure_live = None
            if cfg.backend == "engine":
                measure_live = self._measured_kv_bytes
            self.coordinator = MigrationCoordinator(
                self.load_calc, self.fitted, self.tl, cfg.model,
                tp=cfg.tp, cfg=cfg.migration,
                measure_bytes=measure_live,
            )
        self.scaler = None
        if cfg.scaling:
            self.scaler = Scaler(
                cfg.scaler, self.monitor, self.tl, cfg.model, tp=cfg.tp,
                load_calc=self.load_calc,
                evacuate=cfg.live_migration,
            )

        # event loop state (stepped incrementally by ServingSession)
        self._events: list = []
        self._eseq = itertools.count()
        self._dispatch_at: Optional[float] = None
        self._migrate_scheduled = False
        # evacuations in progress: wid -> deferred ScaleAction, committed
        # by _check_evacuations the moment the worker drains
        self._evac: dict[int, ScaleAction] = {}
        self.n_live_migrations = 0
        self._rr_decode = 0
        self._fit_seen = 0      # profiler samples consumed by last fit
        self.timeline: list = []
        self.now = 0.0          # virtual clock: time of last processed event
        self._started = False
        self._by_wid: dict[int, Backend] = {w.wid: w for w in self.workers}
        # streaming sinks, installed by ServingSession: per-token
        # emission (rid, token_id|None, t) and request completion
        self.on_token: Optional[callable] = None
        self.on_finish: Optional[callable] = None
        # fault-tolerance sinks + machinery: on_failed fires when a
        # request is shed (terminal), on_retried when recovery re-queues
        # or re-routes one (non-terminal)
        self.on_failed: Optional[callable] = None
        self.on_retried: Optional[callable] = None
        self.recovery = RecoveryManager(
            self, cfg.recovery_cfg, enabled=cfg.recovery
        )

    # -- setup -----------------------------------------------------------------
    def _init_engine_plane(self, device, devices, seed_params, dtype,
                           ckpt_dir: Optional[str]) -> None:
        """Draw (or take) the seed weights, hand them to the
        WeightManager as provisioning source material, and warm up each
        device replicas are placed on; the shared FittedLatencyModel
        doubles as every engine's profiler, so the paper's Appendix-A
        path (measure -> fit -> budget) runs on real step times."""
        import torch

        from repro_torch.models import build
        from repro_torch.serving.engine import EngineConfig
        from repro_torch.serving.weights import WeightManager

        self.devices = placed_devices(device, devices)
        self.device = self.devices[0]
        self._engine_cfg = self.cfg.engine or EngineConfig()
        if self.cfg.prefix_cache:
            # cluster-level opt-in overrides the engine config: every
            # replica (including scale-out arrivals) gets a PrefixCache
            self._engine_cfg = dataclasses.replace(
                self._engine_cfg, prefix_cache=True,
                prefix_cache_pages=self.cfg.prefix_cache_pages,
            )
        if self.cfg.spec_decode:
            # same override pattern: every replica speculates, and
            # warm_decode_blocks below runs the verify buckets too
            self._engine_cfg = dataclasses.replace(
                self._engine_cfg, spec_decode=True,
                max_spec_len=self.cfg.max_spec_len,
            )
        if seed_params is None:
            seed = build.seeded_model(self.cfg.model, self.device,
                                      self.cfg.seed,
                                      dtype=dtype or torch.float32)
        else:
            seed = replica_model(self.cfg.model, {
                k: v.to(self.device, dtype or v.dtype)
                for k, v in seed_params.items()})
        # per-replica weight ownership: the seed is provisioning SOURCE
        # material only (host offload + disk checkpoint + the warm-up
        # engine below) — every replica gets its OWN tensors via a real
        # Table-2 transport, and scale-out measures the move
        self.weights = WeightManager(seed.state_dict(), tl=self.tl,
                                     ckpt_dir=ckpt_dir, devices=self.devices)
        self.truth = None
        self._kv_cap = 0
        self.fitted = FittedLatencyModel()
        cards = [d for d in dict.fromkeys(self.devices) if d.type == "cuda"]
        if cards:
            # build (or load) every kernel library now: nvcc at first
            # use would otherwise land inside a measured step — the
            # page gather, say, inside the first P/D hand-off
            from repro_torch.kernels import _build

            for name in _build.SIGNATURES:
                _build.library(name)
        # warm up with a throwaway engine and a DETACHED profiler on
        # each device a replica may land on: a card's first launches,
        # cuBLAS's and the allocator's set-up must pollute neither the
        # run's virtual clock (every queued request's TTFT) nor the
        # Eq. 5 fit the Dispatcher budgets with
        for dev in dict.fromkeys(self.devices):
            self._warm_up(seed if dev == self.device else replica_model(
                self.cfg.model, {k: v.to(dev)
                                 for k, v in seed.state_dict().items()}))
        # the seed must not stay on the device: beside the replicas and
        # their KV pools it would not fit one card at full width
        del seed
        if cards:
            torch.cuda.empty_cache()

    def _warm_up(self, model) -> None:
        """Serve one tiny request and run the fused decode blocks on a
        throwaway engine over ``model``; raise where the cluster's mode
        needs the paged plane and this model/config falls back."""
        from repro_torch.serving.engine import InferenceEngine

        warm = InferenceEngine(model, self._engine_cfg,
                               profiler=FittedLatencyModel())
        if self.cfg.mode == "pd" and not warm.paged:
            raise ValueError(
                "engine-plane P/D needs the paged KV plane (this "
                "model/config falls back to the slot plane); use "
                "mode='collocated' or a chunk-capable model"
            )
        if self.cfg.live_migration and not warm.paged:
            raise ValueError(
                "engine-plane live migration moves paged KV; this "
                "model/config falls back to the slot plane, which "
                "cannot export mid-decode state"
            )
        # one tiny request: a prefill and a decode step.  On the slot
        # plane that is one padded prefill: eager PyTorch runs any shape
        # without compiling it, so the JAX package's warm-up of the
        # whole (batch, padded length) prefill lattice has no work here
        n_warm = max(1, min(4, self._engine_cfg.max_len - 2))
        warm.submit(Request.from_prompt(
            -1, np.arange(1, n_warm + 1, dtype=np.int32), max_new=2))
        warm.run_until_done(max_steps=64)
        # the fused decode blocks (one per power-of-two K bucket): a
        # tiny warm request never reaches K > 1
        warm.warm_decode_blocks()

    def _make_worker(self, wid: int, role: str, active: bool = True,
                     strategy: str = "cpu",
                     donor: Optional[int] = None) -> Backend:
        cfg = self.cfg
        if cfg.backend == "engine":
            from repro_torch.serving.engine import InferenceEngine

            # materialize this replica's OWN weights through the
            # selected transport; the measured wall time is kept for
            # the scale-out delay and feeds the TLManager's observed
            # transfer model (via WeightManager.provision).  A transport
            # can fail (injected fault, or the d2d donor died mid-pull):
            # fall back along the chain of slower-but-surer sources.
            chain = {"d2d": ("d2d", "cpu", "disk"),
                     "cpu": ("cpu", "disk")}.get(strategy, (strategy,))
            params = None
            last_err: Optional[Exception] = None
            for i, s in enumerate(chain):
                if (self.faults is not None and i + 1 < len(chain)
                        and self.faults.fail_weight_load(self.now, s)):
                    self.timeline.append(
                        (self.now, wid, f"weight_fail:{s}")
                    )
                    continue
                try:
                    params, self._provision_s = self.weights.provision(
                        wid, s, donor=donor if s == "d2d" else None
                    )
                except ValueError as e:   # e.g. donor no longer owns
                    last_err = e
                    continue
                self._provision_strategy = s
                break
            if params is None:
                raise last_err or ValueError(
                    f"no weight source available for worker {wid}"
                )
            eng = InferenceEngine(replica_model(self.cfg.model, params),
                                  self._engine_cfg, profiler=self.fitted)
            return EngineWorker(wid, role, eng, active=active)
        return SimWorker(
            wid, role, self.truth, self._kv_cap,
            np.random.default_rng(cfg.seed + 1000 + wid),
            noise=cfg.noise, active=active, chunk_tokens=cfg.chunk_tokens,
            prefix_index=self.prefix_index, spec_decode=cfg.spec_decode,
            max_spec_len=cfg.max_spec_len,
            spec_accept_rate=cfg.spec_accept_rate,
        )

    def _initial_roles(self) -> list[str]:
        if self.cfg.mode == "pd":
            return (["prefill"] * self.cfg.n_prefill
                    + ["decode"] * self.cfg.n_decode)
        return ["collocated"] * self.cfg.n_workers

    def _kv_capacity(self) -> int:
        cfg = self.cfg
        weight_bytes = cfg.model.param_count() * 2 / max(cfg.tp, 1)
        free = max(cfg.hw.hbm_capacity - weight_bytes, 2e9)
        kv_per_tok = AnalyticLatencyModel._kv_bytes_per_token(cfg.model, 2)
        if kv_per_tok <= 0:  # SSM: state only; token capacity is huge
            return 10_000_000
        return int(cfg.tp * free / kv_per_tok)

    def _materialize_prompts(self, requests: Sequence[Request]) -> None:
        """Engine plane needs real token ids; workloads that only carry
        lengths get deterministic synthetic prompts.  Every request is
        validated against the engine's full admission constraints
        (max_len AND the paged fit-alone page bound) up front, so an
        impossible workload fails before the run, not mid-dispatch."""
        from repro_torch.serving.workload import materialize_prompts

        materialize_prompts(
            requests, self.cfg.model.vocab_size, seed=self.cfg.seed,
        )
        # engine.validate is the single validation authority (max_len
        # AND the paged fit-alone bound); replicas share one config
        probe = self.workers[0].engine
        for r in requests:
            probe.validate(r)

    def _measured_kv_bytes(self, r: Request,
                           src: Optional[int] = None) -> Optional[float]:
        """Measured payload bytes a migration of ``r`` would move,
        from the holding worker (``src``; defaults to the prefill
        worker for the P/D hand-off path).  Resolved through the
        ``_by_wid`` index, which retains deactivated workers — a
        scaled-in source's KV stays resident until the transfer lands,
        and its bytes must still cost the move (never silently fall
        back to the analytic estimate mid-scale-in)."""
        w = self._by_wid.get(r.prefill_worker if src is None else src)
        return w.kv_payload_bytes(r) if w is not None else None

    def _pick_donor(self) -> Optional[int]:
        """d2d weight-donor selection: the least-loaded ACTIVE replica
        still owning a live params tree (queue+batch occupancy first,
        monitor utilization as tie-break) — pulling from the idlest
        donor keeps the copy off the hot path.  None = no live donor
        (scale-from-zero); the caller falls back to ``disk``."""
        if self.weights is None:
            return None
        cands = [w for w in self.workers
                 if w.active and not w.evacuating and not w.crashed
                 and self.weights.owns(w.wid)]
        if not cands:
            return None

        def load(w):
            snap = self.monitor.snapshot(w.wid)
            return (len(w.waiting) + len(w.running),
                    snap.utilization if snap else 0.0, w.wid)

        return min(cands, key=load).wid

    # -- event machinery ----------------------------------------------------------
    def _push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._events, (t, next(self._eseq), kind, payload))

    def _schedule_dispatch(self, t: float) -> None:
        if self._dispatch_at is None or t < self._dispatch_at - 1e-12:
            self._dispatch_at = t
            self._push(t, "dispatch")

    def _schedule_worker(self, w: Backend, t: float) -> None:
        if not w.step_pending and w.active:
            w.step_pending = True
            self._push(t, "worker_step", w.wid)

    # -- dispatch callback (policy -> worker) ----------------------------------------
    def _do_dispatch(self, worker: Backend, reqs: Sequence[Request],
                     now: float) -> None:
        for r in reqs:
            r.prefill_worker = worker.wid
        worker.submit(list(reqs), now)
        if self.cfg.mode == "pd" and self.cfg.one_shot_pd:
            # one-shot: decode instance fixed at arrival time (RR)
            decodes = [w for w in self.workers if w.role == "decode"
                       and w.active]
            for r in reqs:
                if decodes:
                    r.decode_worker = decodes[
                        self._rr_decode % len(decodes)
                    ].wid
                    self._rr_decode += 1
        if worker.busy_until <= now:
            self._schedule_worker(worker, now)

    # -- incremental event-loop API (driven by ServingSession) ---------------------
    def start(self) -> None:
        """Arm the recurring control-plane events (monitor, scaler).
        Idempotent; called once by the first ServingSession attach."""
        if self._started:
            return
        self._started = True
        self._push(self.now, "monitor")
        if self.scaler is not None:
            self._push(self.now + self.cfg.scaler.tau, "scaler")
        if self.faults is not None:
            # scripted crashes enter the event stream up front — they
            # are part of the deterministic replay, not RNG draws
            for c in self.faults.crashes:
                self._push(max(c.t, self.now), "replica_crash", c.wid)

    def enqueue(self, r: Request) -> None:
        """Schedule ``r``'s arrival.  An arrival stamped before the
        processed clock (wall-clock submissions racing the loop) is
        delivered immediately — the virtual clock never runs backwards,
        while ``r.arrival`` keeps the true submit time for metrics."""
        self._push(max(r.arrival, self.now), "arrival", r)

    def next_event_time(self) -> Optional[float]:
        return self._events[0][0] if self._events else None

    def process_next(self) -> Optional[str]:
        """Pop and handle one event; returns its kind (None if idle).
        Advances ``self.now`` to the event's time."""
        if not self._events:
            return None
        now, _, kind, payload = heapq.heappop(self._events)
        self.now = now
        self._handle(kind, payload, now)
        return kind

    def _handle(self, kind: str, payload, now: float) -> None:
        cfg = self.cfg
        by_wid = self._by_wid

        if kind == "arrival":
            r: Request = payload
            if cfg.slo_mapper is not None and r.priority is not None:
                hp = any(
                    q.priority is not None and q.priority < r.priority
                    for q in self.policy.queued_requests()
                )
                r.ttft_slo, r.tpot_slo = cfg.slo_mapper.assign(
                    r.priority, higher_priority_pending=hp
                )
            self.monitor.note_arrival()
            self.policy.on_request_arrive(r)
            self._schedule_dispatch(now)

        elif kind == "dispatch":
            if self._dispatch_at is not None and now >= (
                self._dispatch_at - 1e-12
            ):
                self._dispatch_at = None
            self.policy.dispatch_pass(now)
            nw = self.policy.next_wakeup()
            if self.policy.pending() and nw is not None:
                self._schedule_dispatch(max(nw, now + 1e-6))
            elif self.policy.pending():
                self._schedule_dispatch(now + 0.01)

        elif kind == "worker_step":
            w = by_wid[payload]
            w.step_pending = False
            if not w.active or now < w.busy_until - 1e-12:
                pass
            else:
                out = w.run_step(now)
                if out is not None:
                    if (self.faults is not None
                            and self.faults.has_stragglers()):
                        f = self.faults.slowdown(w.wid, now)
                        if f > 1.0:
                            # stretch the in-flight step: the worker
                            # stays busy (and billed) for the slowdown
                            delta = out.duration * (f - 1.0)
                            out.duration += delta
                            w.busy_until += delta
                            w.busy_time += delta
                    self._push(now + out.duration, "step_done",
                               (w.wid, out))
                    w.step_pending = True

        elif kind == "step_done":
            wid, out = payload
            w = by_wid[wid]
            w.step_pending = False
            if w.crashed:
                # the step died with the process; its residents were
                # (or will be) re-homed by the watchdog
                return
            ev = w.finish_step(out, now)
            # stream tokens before completions so a FIRST_TOKEN always
            # precedes its own FINISHED in any subscriber's log
            if self.on_token is not None:
                for rid, tok, t in ev.tokens:
                    self.on_token(rid, tok, t)
            for r in ev.finished:
                self._finish(r, now)
            if out.kind == "prefill":
                for r in ev.parked:
                    if self.migrator is not None:
                        self.migrator.on_prefill_complete(r)
                    else:  # one-shot: start transfer immediately
                        dst = by_wid.get(r.decode_worker)
                        t_x = self.tl.kv_transfer_time(
                            cfg.model, r.l_in, wid,
                            dst.wid if dst else wid, tp=cfg.tp,
                        )
                        self._push(now + t_x, "kv_ready",
                                   (r, r.decode_worker, wid))
            if self.migrator is not None:
                self._schedule_migrate(now)
            if self._evac:
                # a finishing request may have been the last thing
                # pinning an evacuating worker
                self._check_evacuations(now)
            if w.has_work():
                self._schedule_worker(w, now)
            if out.kind == "prefill":
                # maturity correction applies to prefill only —
                # decode iterations are the slack Eq. 5 budgets
                # against; only a *prefill* finishing early frees
                # the worker ahead of estimate.
                self.policy.notify_worker_free(w.wid, now)
            self._schedule_dispatch(now)

        elif kind == "migrate":
            self._migrate_scheduled = False
            decodes = [w for w in self.workers if w.role == "decode"
                       and not w.evacuating]
            moves = self.migrator.migrate_pass(now, decodes)
            for r, dst, t_x in moves:
                self._push(now + t_x, "kv_ready",
                           (r, dst.wid, r.prefill_worker))

        elif kind == "kv_ready":
            r, dst_wid, src_wid = payload
            # release only OUR reservation: a crash may have re-queued
            # this request and a fresh transfer (new dst) may already
            # hold a new charge this stale event must not drop
            if self._mig_ledger.dst_of(r.rid) == dst_wid:
                self._mig_ledger.release(r.rid)
            live = r.migrating
            r.migrating = False
            src = by_wid.get(src_wid)
            dst = by_wid.get(dst_wid)
            if (r.state in (RequestState.FINISHED, RequestState.FAILED)
                    or src is None or src.crashed
                    or not src.holds_kv(r)):
                # nothing left to move: the request finished during the
                # flight (a live-migration source keeps decoding until
                # the transfer lands) or was recompute-preempted at the
                # source (its KV is gone; the re-prefill owns it now)
                r.migrate_ready = None
                if self._evac:
                    self._check_evacuations(now)
                return
            if dst is None or not dst.active or dst.evacuating:
                # destination vanished (scale-in) or began evacuating
                # mid-transfer: the source keeps the KV resident until
                # a transfer actually lands somewhere.  Clear the stale
                # placement — a dead wid in decode_worker would
                # misdirect anything keying on it.
                r.decode_worker = None
                r.migrate_ready = None
                if not live and self.migrator is not None:
                    self.migrator.on_prefill_complete(r)
                    self._schedule_migrate(now)
                # live moves just stay on their source; the next
                # coordinator pass re-plans them
                return
            if (self.faults is not None
                    and self.faults.drop_kv_transfer(now, r.rid,
                                                     src_wid, dst_wid)):
                # the transfer failed in flight: KV stays resident at
                # the source; recovery retries (capped backoff,
                # alternate destination) or falls back
                self.timeline.append(
                    (now, src_wid, f"kv_drop:{r.rid}->{dst_wid}")
                )
                self.recovery.on_transfer_fail(
                    r, src_wid, dst_wid, now, live
                )
                return
            if src is not None:
                # engine plane: materialize the pages + generation
                # state (captured at transfer completion, so a
                # mid-decode source contributes its newest tokens);
                # sim plane: nothing physical to move
                pk = src.export_kv(r)
                if pk is not None:
                    r.kv_payload = pk
                src.free_kv(r)
                if src.active and src.has_work():
                    # the freed slot/pages may unblock prompts that
                    # queued while the source was fully parked
                    self._schedule_worker(src, now)
            dst.accept_migrated(r, now)
            r.decode_worker = dst.wid
            r.n_migrations += 1
            r.last_migrated = now
            self.recovery.on_transfer_landed(r)
            if live:
                self.n_live_migrations += 1
            self._schedule_worker(dst, now)
            if self._evac:
                # the export above may have drained an evacuating source
                self._check_evacuations(now)

        elif kind == "monitor":
            self.monitor.update(now, [w for w in self.workers
                                      if w.active])
            # health watchdog rides the monitor cadence: detection
            # latency for a crash is at most one monitor interval
            self.recovery.watchdog(now)
            if cfg.backend == "engine":
                # refit Eq. 1/2 from the engines' measured steps so
                # the Dispatcher budgets on live coefficients —
                # but only when new samples landed since last tick
                n = self.fitted.n_samples()
                if n > self._fit_seen:
                    self.fitted.fit(min_samples=4)
                    self._fit_seen = n
            if self.coordinator is not None:
                # live-migration planning rides the monitor cadence:
                # rescue predicted-miss requests, rebalance ramps, and
                # retry evacuations whose victims had nowhere to go
                self._rebalance(now)
                if self._evac:
                    self._check_evacuations(now)
            self._push(now + self.monitor.interval, "monitor")

        elif kind == "scaler":
            self._scaler_tick(now, by_wid)
            self._push(now + cfg.scaler.tau, "scaler")

        elif kind == "worker_up":
            wid, role = payload
            w = by_wid[wid]
            w.activate(now, role)
            self.tl.ensure_links(wid, [x.wid for x in self.workers
                                       if x.wid != wid])
            if role in ("collocated", "prefill"):
                self.policy.add_worker(w, now)
            self.timeline.append((now, wid, f"up:{role}"))
            self._schedule_dispatch(now)
            if self.migrator is not None:
                self._schedule_migrate(now)

        elif kind == "role_flip":
            wid, role = payload
            self._apply_role_flip(by_wid[wid], role, now)
            self._schedule_dispatch(now)
            if self.migrator is not None:
                self._schedule_migrate(now)

        elif kind == "replica_crash":
            w = by_wid.get(payload)
            if w is not None and w.active and not w.crashed:
                # the process is gone NOW; recovery (resident re-homing,
                # weight release) runs at the next watchdog tick, which
                # models the detection latency
                w.crashed = True
                w.deactivate(now)
                if self.faults is not None:
                    self.faults.note(now, "crash", f"wid={w.wid}")
                self.recovery.note_crash(w.wid, now)
                self.timeline.append((now, w.wid, "crash"))

        elif kind == "kv_retry":
            self.recovery.retry_transfer(payload, now)

    def collect_result(self, requests: Sequence[Request]) -> ClusterResult:
        makespan = self.now
        cost = sum(w.total_up_time(makespan) for w in self.workers) / (
            COST_UNIT
        )
        m = compute_metrics(list(requests), cost, makespan)
        hist: dict[int, int] = {}
        n_dec_tok = n_disp = n_pf = 0
        sp_disp = sp_prop = sp_acc = 0
        pstats: dict = {}
        if self.cfg.backend == "engine":
            for w in self.workers:
                for k, n in w.engine.decode_block_hist.items():
                    hist[k] = hist.get(k, 0) + n
                n_dec_tok += w.engine.n_decode_tokens
                n_disp += w.engine.n_dispatches
                n_pf += w.engine.n_prefill_tokens
                sp_disp += w.engine.n_spec_dispatches
                sp_prop += w.engine.n_spec_proposed
                sp_acc += w.engine.n_spec_accepted
                if w.engine.prefix is not None:
                    for k, v in w.engine.prefix.stats().items():
                        pstats[k] = pstats.get(k, 0) + v
        else:
            for w in self.workers:
                sp_disp += w.spec_dispatches
                sp_prop += w.spec_proposed
                sp_acc += w.spec_accepted
            if self.prefix_index is not None:
                pstats = self.prefix_index.stats()
        return ClusterResult(
            metrics=m,
            requests=list(requests),
            timeline=self.timeline,
            monitor=self.monitor,
            n_scale_out=self.scaler.n_scale_out if self.scaler else 0,
            n_scale_in=self.scaler.n_scale_in if self.scaler else 0,
            n_role_flips=self.scaler.n_role_flips if self.scaler else 0,
            kv_transfers=self.tl.n_kv_transfers,
            decode_block_hist=hist,
            n_decode_tokens=n_dec_tok,
            n_dispatches=n_disp,
            n_prefill_tokens=n_pf,
            prefix_stats=pstats,
            n_live_migrations=self.n_live_migrations,
            n_rescues=(self.coordinator.n_rescues
                       if self.coordinator else 0),
            n_evacuations=(self.coordinator.n_evacuations
                           if self.coordinator else 0),
            n_faults=self.faults.n_injected if self.faults else 0,
            n_recovered=self.recovery.n_recovered,
            n_lost=self.recovery.n_lost,
            n_transfer_retries=self.recovery.n_transfer_retries,
            recovery_latency_s=round(self.recovery.recovery_latency_s, 4),
            spec_dispatches=sp_disp,
            spec_proposed=sp_prop,
            spec_accepted=sp_acc,
        )

    # -- batch adapter -------------------------------------------------------------
    def run(self, requests: Sequence[Request]) -> ClusterResult:
        """Closed-world replay: submit the whole workload through a
        ServingSession and drain it.  Thin adapter — the event loop
        lives in :class:`~repro_torch.serving.session.ServingSession`, so the
        batch and online paths cannot diverge."""
        from repro_torch.serving.session import ServingSession

        if self.cfg.backend == "engine":
            self._materialize_prompts(requests)
        for r in requests:
            if r.arrival is None:  # open-loop default: all at t=0
                r.arrival = 0.0
        session = ServingSession(self, admission="none")
        for r in requests:
            session.submit_request(r)
        session.drain()
        return session.close(requests=list(requests))

    # -- helpers ------------------------------------------------------------------
    def _finish(self, r: Request, now: float) -> None:
        self.monitor.note_completion()
        cfg = self.cfg
        if cfg.slo_mapper is not None and r.priority is not None:
            q_time = (r.dispatch_time or r.arrival) - r.arrival
            if r.ttft is not None and r.tpot is not None:
                cfg.slo_mapper.observe(
                    r.priority, r.ttft, max(r.tpot, 1e-4), q_time
                )
        if self.on_finish is not None:
            self.on_finish(r, now)

    def _apply_role_flip(self, w: Backend, role: str, now: float) -> bool:
        """Commit a scheduled role transition.  The scaler only flips
        drained workers, but demand can land during the transition
        delay — re-check at commit time and abort rather than strand
        freshly-dispatched work on a wrong-role worker (a sim prefill
        worker flipped to decode would never drain its waiting queue)."""
        if role != w.role and not w.is_drained():
            self.timeline.append((now, w.wid, f"role_flip_skipped:{role}"))
            return False
        was = w.role
        w.role = role
        if role in ("collocated", "prefill"):
            self.policy.add_worker(w, now)
        elif was in ("collocated", "prefill"):
            self.policy.remove_worker(w.wid)
        self.timeline.append((now, w.wid, f"role:{was}->{role}"))
        return True

    def _schedule_migrate(self, now: float) -> None:
        if self.migrator is not None and not self._migrate_scheduled:
            self._migrate_scheduled = True
            self._push(now, "migrate")

    # -- live migration (decode-to-decode) -----------------------------------------
    def _rebalance(self, now: float) -> None:
        """One MigrationCoordinator planning pass: evacuate workers the
        scaler wants emptied and rescue predicted-TPOT-miss requests
        onto less-loaded decode instances.  Each planned move schedules
        a ``kv_ready`` after the TLManager-costed transfer time; the
        victim keeps decoding on its source until the transfer lands."""
        moves = self.coordinator.plan(now, self.workers,
                                      evacuating=self._evac.keys())
        for r, src, dst, t_x, reason in moves:
            r.migrate_ready = now + t_x
            self._push(now + t_x, "kv_ready", (r, dst.wid, src.wid))
            self.timeline.append(
                (now, src.wid, f"migrate:{reason}:{r.rid}->{dst.wid}")
            )

    def _begin_evacuation(self, w: Backend, a, now: float) -> None:
        """Start emptying ``w`` for a deferred scale-in / role flip.
        The worker stops taking new placements immediately (policy
        removal + ``evacuating`` flag, which the Migrator/coordinator
        destination filters honor); its residents are live-migrated off
        and the pending action commits in :meth:`_check_evacuations`
        the moment it drains."""
        if w.evacuating or w.wid in self._evac:
            return
        w.evacuating = True
        self._evac[w.wid] = a
        if w.role in ("collocated", "prefill"):
            self.policy.remove_worker(w.wid)
        self.timeline.append(
            (now, w.wid, f"evacuate:{a.kind}:{a.role}")
        )
        self._rebalance(now)
        self._check_evacuations(now)

    def _check_evacuations(self, now: float) -> None:
        """Commit pending evacuations whose worker has drained: the
        deferred scale-in deactivates it, the deferred role flip is
        pushed with its normal transition delay.  In-flight exports
        keep the source undrained (running/parked non-empty) until
        their ``kv_ready`` frees the KV, so committing here can never
        strand a resident request."""
        done = [wid for wid, a in self._evac.items()
                if self._by_wid[wid].is_drained()]
        for wid in done:
            a = self._evac.pop(wid)
            w = self._by_wid[wid]
            w.evacuating = False
            if a.kind == "role":
                self._push(now + a.delay, "role_flip", (wid, a.role))
            else:
                self._commit_scale_in(w, now)

    def _commit_scale_in(self, w: Backend, now: float) -> None:
        w.deactivate(now)
        if self.cfg.backend == "engine":
            # reclaim the replica's owned weight copy (it also
            # stops being a d2d donor candidate)
            self.weights.release(w.wid)
            w.engine.release_weights()
        if w.role in ("collocated", "prefill"):
            self.policy.remove_worker(w.wid)
        self.timeline.append((now, w.wid, "scale_in"))

    def _scaler_tick(self, now: float, by_wid) -> None:
        cfg = self.cfg
        queued = self.policy.queued_requests()
        if cfg.mode == "pd":
            dq = self.migrator.queue.items() if self.migrator else []
            actions = self.scaler.tick_pd(now, self.workers, queued, dq)
        else:
            actions = self.scaler.tick(now, self.workers, queued,
                                       pool="any")
        for a in actions:
            if a.kind == "out":
                role = a.role if a.role != "any" else "collocated"
                strategy = a.strategy or cfg.scaler.weight_strategy
                donor = None
                if cfg.backend == "engine":
                    donor = self._pick_donor()
                    if strategy == "d2d" and donor is None:
                        # commit-time re-check: the donor the scaler
                        # assumed may have scaled in since its tick
                        strategy = "disk"
                if cfg.backend != "engine" and self.faults is not None:
                    # sim plane: weight-load faults walk the same
                    # fallback chain; the slower transport's modeled
                    # time replaces the scaler's assumed delay
                    chain = {"d2d": ("d2d", "cpu", "disk"),
                             "cpu": ("cpu", "disk")}.get(strategy,
                                                         (strategy,))
                    for i, s in enumerate(chain):
                        if (i + 1 < len(chain)
                                and self.faults.fail_weight_load(now, s)):
                            self.timeline.append(
                                (now, self._next_wid, f"weight_fail:{s}")
                            )
                            continue
                        if s != strategy:
                            strategy = s
                            a.delay = self.tl.weight_load_time(
                                cfg.model, s, tp=cfg.tp, warm=a.warm
                            )
                        break
                w = self._make_worker(self._next_wid, role, active=False,
                                      strategy=strategy, donor=donor)
                delay = a.delay
                if cfg.backend == "engine":
                    # the provisioning transfer really ran: the
                    # measured wall time (plus runtime init when the
                    # warm pool was dry) IS the cold-start delay
                    delay = self._provision_s + (
                        0.0 if a.warm else self.tl.costs.runtime_warmup
                    )
                    # the fallback chain may have demoted the transport
                    strategy = self._provision_strategy or strategy
                self.workers.append(w)
                by_wid[w.wid] = w
                self._next_wid += 1
                self._push(now + delay, "worker_up", (w.wid, role))
                self.timeline.append(
                    (now, w.wid, f"scale_out:{strategy}({delay:.2f}s)")
                )
            elif a.kind == "in":
                w = by_wid[a.worker_id]
                if w.evacuating:
                    continue  # already being emptied for another action
                if self.coordinator is not None and not w.is_drained():
                    # migrate-then-scale-in: empty the target first,
                    # commit the moment it drains
                    self._begin_evacuation(w, a, now)
                else:
                    self._commit_scale_in(w, now)
            elif a.kind == "role":
                w = by_wid[a.worker_id]
                if w.evacuating:
                    continue
                if self.coordinator is not None and not w.is_drained():
                    # migrate-then-flip: residents move off live instead
                    # of the pool waiting for a natural drain
                    self._begin_evacuation(w, a, now)
                else:
                    self._push(now + a.delay, "role_flip",
                               (w.wid, a.role))


def placed_devices(device=None, devices=None) -> list:
    """The devices an engine-plane ``Cluster``'s replicas round-robin
    over: ``devices`` if given; else, for a CUDA ``device`` without an
    index (the default), every visible card, as JAX's ``jax.devices()``;
    else ``device`` alone (:func:`repro_torch.resolve_device`, raising
    where CUDA is asked for and absent)."""
    import torch

    from repro_torch import resolve_device

    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("devices lists no device")
        return out
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def replica_model(model_cfg: ModelConfig, params: dict):
    """A ``Model`` holding ``params`` themselves, not a copy: its
    skeleton is built on the meta device, so no zero-filled set of
    weights is ever allocated, and the tensors are assigned."""
    from repro_torch.models.build import Model

    first = next(iter(params.values()))
    model = Model(model_cfg, dtype=first.dtype, device="meta")
    model.load_state_dict(params, strict=True, assign=True)
    model.device = first.device
    return model


def run_cluster(cfg: ClusterConfig, requests) -> ClusterResult:
    return Cluster(cfg).run(requests)
