"""Inference engine of the port: continuous batching over a real model.

Counterpart of ``repro/serving/engine.py``, with its two execution
planes, picked as there: ``paged=None`` takes the paged plane when the
model supports it (``Model.supports_chunked``) and the slot plane
otherwise.

**Paged / chunked plane** (qwen7b, mamba2-2.7b, zamba2-7b): attention
K/V lives in a shared pool of fixed-size pages
(:class:`~repro_torch.serving.kv_manager.PagedKVManager`); prompts
prefill in chunks sized by the Eq. 5 token budget; the engine alternates
one prefill chunk with one decode step whenever both have work; decode
runs as fused K-iteration blocks (``Model.decode_block``) with the K
picked as in the JAX engine; an oversubscribed pool recompute-preempts
the youngest request.  Mamba-2 conv and SSM state is O(1) per sequence
and stays in slot rows beside the pool (a chunk of length 0 leaves a
row's state as it was); ``clear_rows`` zeroes a row at release and
preemption.  Measured step times feed the
:class:`FittedLatencyModel` profiler exactly as the paper's Appendix-A
profiler does, and they are taken around the dispatch with
``torch.cuda.synchronize()`` on the card (``block_until_ready`` in JAX).

P/D disaggregation: with ``park_on_prefill`` set, a request whose
prompt completes parks with its pages resident until ``export_kv``
materializes its cache (pages through the page-gather kernel, slot rows
as copies) and ``import_kv`` installs it on another engine, whose page
size may differ, which continues token-identically.

**Slot plane** (gemma3-4b, whose sliding-window layers the paged plane
does not run; any chunk-capable model with ``paged=False``, where a
Mamba-2 prefill whose padded length is a multiple of the SSM chunk runs
the SSD kernel): each request owns one row of contiguous per-layer caches
(``Model.init_cache``).  Queued prompts are admitted under the Eq. 5
token budget at the engine boundary, prefilled whole in one padded
batch (``Model.prefill``, prompt length padded to a power of two) and
copied into their rows (``insert_rows``); decode runs per token
(``Model.decode_step``) or in fused K-blocks
(``Model.decode_block_slots``); a retired row is wiped
(``clear_rows``).  As in the JAX engine, ``export_kv`` / ``import_kv``
raise on this plane, ``kv_bytes_of`` returns None, and the prefix cache
and speculative decoding are refused with ``ValueError``.

**Prefix cache** (``prefix_cache=True``, paged plane, pure-attention
models): a :class:`~repro_torch.serving.prefix_cache.PrefixCache` over
the pool's allocator.  At admission a request's table starts at the
longest cached full-page prefix of its prompt (``lookup_prefix``) and
prefill resumes from the hit offset (``prefix_hit_tokens``); at prefill
completion its full-page span is published.  ``peek_prefix`` tells the
Dispatcher the hit a lookup would give.

**SLO-customized speculative decoding** (``spec_decode=True``, paged
plane, pure-attention models): when decode owns the step, each active
lane gets a depth from its TPOT slack (``slo_spec_len``), an n-gram
drafter fills it from the request's own history, one
``Model.spec_decode_block`` verifies every lane in a C == K + 1 pass
(plain chunk attention; a pass whose lanes all drafted nothing falls
through to a plain decode step or block) and the page table is truncated
back to the accepted position.  Greedy acceptance keeps the tokens those
of plain decoding.

On the slot plane both features are refused with the JAX engine's
``ValueError``, and so they are on the paged plane for a model with
Mamba-2 layers: its slot-resident state cannot be shared by page or
truncated back.  ``fn_cache`` has no counterpart: PyTorch runs eagerly,
with nothing to compile or share.  ``warm_decode_blocks`` runs one
all-frozen decode block per power-of-two K and, with speculation on, one
all-frozen verify pass per power-of-two proposal width up to
``max_spec_len``, outputs discarded, as the JAX engine compiles them:
the cluster calls it on a throwaway engine so that the first kernel
launches, cuBLAS's and the allocator's set-up land in no measured step.

**Decode as a CUDA graph** (paged plane, on the card, a model built
with its kernels): the first paged decode dispatch captures one decode
iteration (a C == 1 ``chunk_step`` over the engine's page pools, then
``Model._decode_block_body``) as a CUDA graph, :class:`_DecodeGraph`,
after one eager iteration on all-frozen rows; ``warm_decode_blocks``
captures it too.  Every decode iteration the engine dispatches then
replays it: once for a K == 1 step, K times chained on the card for a
fused block.  Its inputs are static buffers: the page table (the KV
manager's one device buffer, uploaded into when the table changed),
``(last, pos, alive, rem)`` (``last`` and ``pos`` uploaded only after a
host-side change; otherwise the last replay's outputs, which each
replay writes back into its inputs), and its captured launches are added
to ``_build``'s counts at each replay.  The host issues one graph
launch for the ~2,500 launches of an iteration.  ``decode_graph_iters``
of ``decode_iters`` count the iterations replayed; each decode step's
event says whether it replayed (``graph``).  The CPU, the slot plane
and speculative verify passes run eagerly, as does everything inside
``_forced_eager()`` (a check's comparison of the two paths).

With the span recorder of ``serving/tracing.py`` on, each ``step()``
records its schedule, dispatch, sync and commit at the stamps the
profiler's ``dt`` is taken from (``_timed``), and each request its time
in the queue; off, a step pays one flag test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.latency_model import FittedLatencyModel
from repro_torch.core.request import Request, RequestState
from repro_torch.core.token_budget import ntoken_limit
from repro_torch.kernels import _build
from repro_torch.models.build import Model
from repro_torch.serving.kv_manager import (
    KVPayload,
    PagedKVManager,
    SlotManager,
    clear_rows,
    gather_slot_kv,
    insert_rows,
    scatter_slot_kv,
)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.spec_decode import (
    NGramDrafter,
    SpecConfig,
    slo_spec_len,
)
from repro_torch.serving import tracing


_EAGER_ONLY = [0]   # > 0 inside _forced_eager()


@contextlib.contextmanager
def _forced_eager():
    """For checks only: inside the block no engine captures or replays
    its decode graph, so that a test or ``chip_smoke.py`` can compare
    the eager path with the graph path, or hold each kernel call to its
    plain version (a replay calls no Python)."""
    _EAGER_ONLY[0] += 1
    try:
        yield
    finally:
        _EAGER_ONLY[0] -= 1


class _DecodeGraph:
    """One paged decode iteration of ``engine``, captured as a CUDA
    graph over its page pools, its KV manager's device table and static
    inputs.

    ``state`` (4, n_slots) int32 holds the iteration's inputs ``last``,
    ``pos``, ``alive`` (as 0 / 1) and ``rem``; a replay writes its
    outputs (the token, the new position, alive and remaining budget)
    back into it, so that K replays chain on the card, and the input
    ``alive`` into ``valid`` (the rows that emitted).  ``launches`` are
    the kernel launches one replay makes, by kernel.  The graph holds the
    addresses of the engine's cache leaves: the engine writes its caches
    in place and never replaces them."""

    def __init__(self, engine: "InferenceEngine"):
        cfg, dev, model = engine.cfg, engine.device, engine.model
        caches = engine.caches
        self.state = torch.zeros((4, cfg.n_slots), dtype=torch.int32,
                                 device=dev)
        self.valid = torch.zeros(cfg.n_slots, dtype=torch.bool, device=dev)
        self.views = (self.state[0], self.state[1])   # (last, pos)
        self.host = np.zeros((4, cfg.n_slots), np.int32)  # upload staging
        table = engine.kv.device_table()
        eos = -1 if cfg.eos_token is None else cfg.eos_token

        @torch.no_grad()
        def body():
            last, pos, lens, rem = self.state
            logits, _ = model.chunk_step(caches, table, last[:, None], pos,
                                         lens)
            tok, new_pos, alive, new_rem = model._decode_block_body(
                last, pos, lens.bool(), rem, eos, cfg.max_len, logits)
            self.valid.copy_(lens)
            self.state.copy_(torch.stack(
                [tok, new_pos, alive.to(torch.int32), new_rem]))

        # one eager iteration on frozen rows first (its writes dropped),
        # on the capture's stream: first launches, cuBLAS's workspace
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            with _build.uncounted():
                body()
            self.graph = torch.cuda.CUDAGraph()
            with _build.uncounted() as self.launches:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    body()
                finally:
                    self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)

    def replay(self, k: int, toks=None, valids=None) -> None:
        """``k`` iterations on the current stream; with ``toks`` /
        ``valids`` (n_slots, k), each iteration's token and emitting
        rows go into column i."""
        for i in range(k):
            self.graph.replay()
            if toks is not None:
                toks[:, i].copy_(self.state[0])
                valids[:, i].copy_(self.valid)
        _build.add_launches({name: n * k for name, n in self.launches.items()})


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 8
    max_len: int = 128
    prefill_batch: int = 4          # max sequences per prefill step
    slo_aware: bool = True          # Eq. 5 admission at the engine
    eos_token: Optional[int] = None
    # paged / chunked execution plane
    paged: Optional[bool] = None    # None = auto (paged when supported)
    page_size: int = 16
    n_pages: Optional[int] = None   # default: n_slots * ceil(max_len/ps)
    chunk_size: int = 32            # static ceiling per prefill chunk
    # max decode iterations per fused block (1 = per-token stepping)
    decode_block: int = 8
    # prefix cache: page-level KV reuse across requests (paged plane,
    # pure-attention models only)
    prefix_cache: bool = False
    prefix_cache_pages: Optional[int] = None  # cache footprint cap
    # SLO-customized speculative decoding (paged plane, pure-attention
    # models): per-lane depth from each request's TPOT slack, capped at
    # max_spec_len
    spec_decode: bool = False
    max_spec_len: int = 8

    @classmethod
    def smoke(cls, **overrides) -> "EngineConfig":
        """The canonical CPU-sized engine shape examples, benchmarks,
        and CI smoke runs share (pair with smoke model configs and
        clipped workloads, e.g. ``workload.engine_smoke_workload``)."""
        kw = dict(n_slots=4, max_len=48, prefill_batch=2, page_size=8,
                  chunk_size=16)
        kw.update(overrides)
        return cls(**kw)


class InferenceEngine:
    def __init__(self, model: Model, cfg: EngineConfig,
                 profiler: Optional[FittedLatencyModel] = None):
        self.paged = (model.supports_chunked if cfg.paged is None
                      else cfg.paged)
        if self.paged and not model.supports_chunked:
            raise ValueError(
                "model has segments the chunked/paged plane does not "
                "support; use paged=False"
            )
        if not self.paged and cfg.prefix_cache:
            raise ValueError(
                "prefix caching requires the paged plane (pages are the "
                "unit of sharing); this model/config runs the slot fallback"
            )
        if not self.paged and cfg.spec_decode:
            raise ValueError(
                "spec_decode requires the paged plane: rollback is "
                "page-table truncation"
            )
        if cfg.prefix_cache and not model.supports_prefix_cache:
            raise ValueError(
                "prefix caching needs pure-attention paged caches: "
                "SSM/conv state is slot-resident, so a shared page "
                "cannot reproduce it; disable prefix_cache for this model"
            )
        if cfg.spec_decode and not model.supports_spec_decode:
            raise ValueError(
                "spec_decode needs pure-attention paged caches: "
                "slot-resident SSM/conv state has no per-position "
                "record to truncate rejected tokens back to"
            )
        if cfg.page_size <= 0 or cfg.chunk_size <= 0:
            raise ValueError("page_size and chunk_size must be positive")
        if cfg.decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        if cfg.spec_decode and cfg.max_spec_len < 1:
            raise ValueError("max_spec_len must be >= 1")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.prefix = None  # PrefixCache, attached on the paged plane
        self.slots = SlotManager(cfg.n_slots)
        if self.paged:
            self.kv = PagedKVManager(cfg.n_slots, cfg.max_len, cfg.page_size,
                                     cfg.n_pages, device=self.device)
            self.caches = model.init_paged_cache(
                cfg.n_slots, cfg.max_len, cfg.page_size, self.kv.n_pages)
            self.axes = model.paged_cache_axes()
            if cfg.prefix_cache:
                self.prefix = PrefixCache(self.kv.alloc, cfg.page_size,
                                          max_pages=cfg.prefix_cache_pages)
                self.kv.attach_prefix_cache(self.prefix)
        else:
            self.kv = None
            self.caches = model.init_cache(cfg.n_slots, cfg.max_len)
            self.axes = model.cache_axes()
        self.queue: list[Request] = []
        self.prefilling: dict[int, Request] = {}  # slot -> req
        self.active: dict[int, Request] = {}
        # P/D: prefill-complete requests whose decode runs elsewhere;
        # their pages stay resident and they never join a decode batch
        self.parked: dict[int, Request] = {}
        self.park_on_prefill = False  # set for prefill-role engines
        self.pos = np.zeros(cfg.n_slots, np.int32)
        self.last_token = np.zeros(cfg.n_slots, np.int32)
        self.profiler = profiler if profiler is not None else (
            FittedLatencyModel())
        self.finished: list[Request] = []
        self.clock = 0.0  # virtual clock advanced by measured step times
        self._turn = "prefill"  # round-robin fairness when both busy
        self._seq = 0           # submit-order stamp (preemption age)
        self._rid_slot: dict[int, int] = {}
        # device-resident (last_token, pos): a decode block's final
        # state feeds the next block; host-side mutations re-upload
        self._dev_state: Optional[tuple] = None
        self._host_state_dirty = True
        self.n_dispatches = 0       # dispatches (= host syncs)
        self.n_decode_tokens = 0    # tokens emitted by decode steps
        # the captured decode iteration (paged plane on the card), and
        # how many decode iterations replayed it of all dispatched
        self._graph: Optional[_DecodeGraph] = None
        self.decode_iters = 0
        self.decode_graph_iters = 0
        # prompt tokens actually prefilled: cache hits skip prefill, so
        # with a prefix cache this undercounts l_in by the hit tokens
        self.n_prefill_tokens = 0
        self.decode_block_hist: dict[int, int] = {}  # K -> n blocks
        # speculative decoding: the drafter and acceptance telemetry
        self.drafter: Optional[NGramDrafter] = None
        self._spec_cfg: Optional[SpecConfig] = None
        self.n_spec_dispatches = 0   # propose-verify dispatches
        self.n_spec_proposed = 0     # drafted tokens sent to verify
        self.n_spec_accepted = 0     # drafted tokens accepted
        self.spec_depth_hist: dict[int, int] = {}  # pad width -> n
        # per-task acceptance stats (the SLO tiers differ by task)
        self.spec_task_stats: dict[str, dict] = {}
        # the recorder's spans (serving/tracing.py): this engine's id and
        # the open step's trace, None while the recorder is off
        self.trace_id = tracing.new_engine_id()
        self._trace: Optional[tracing.StepTrace] = None
        if cfg.spec_decode:
            self._spec_cfg = SpecConfig(max_spec_len=cfg.max_spec_len)
            self.drafter = NGramDrafter(
                max_ngram=self._spec_cfg.max_ngram,
                min_ngram=self._spec_cfg.min_ngram,
            )

    def peek_prefix(self, prompt) -> int:
        """Hit length (tokens) a prefix-cache lookup would return for
        ``prompt`` right now — read-only.  The Dispatcher's admission
        budget charges only the uncached suffix ``l_in - peek``."""
        if self.prefix is None or prompt is None:
            return 0
        return self.kv.peek_prefix(prompt)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _timed(self, call, lanes: int, graph: bool = False, **attrs):
        """One dispatch: ``call()`` (the model call or the decode graph's
        replays, their inputs' uploads included), then the wait for the
        device.  Returns its outputs and ``dt``, the seconds between the
        two stamps the Eq. 5 profiler reads.  The recorder's open step,
        if any, takes those stamps and the call's return as its dispatch
        and sync, after ``t1``; ``lanes``, ``graph`` (1 for replays) and
        ``attrs`` go on its dispatch span.  Only
        the return's stamp, and under a recording profiler the switch of
        ``record_function`` ranges, fall inside ``dt``."""
        tr = self._trace
        noted = tr is not None and tr.notes is not None
        t0 = time.perf_counter()
        if noted:
            tr.switch("engine.dispatch")
        out = call()
        if tr is not None:
            back = tracing.now()
            if noted:
                tr.switch("engine.sync")
        self._sync()
        t1 = time.perf_counter()
        if tr is not None:
            if noted:
                tr.switch("engine.commit")
            tr.dispatched(t0, back, t1, dict(lanes=int(lanes),
                                             graph=int(graph), **attrs))
        return out, t1 - t0

    def _trace_queue(self, rid: int, opens: bool) -> None:
        """Request ``rid`` enters (``opens``) or leaves this engine's
        queue: the recorder's ``request.queue`` span."""
        if tracing.RECORDER.on:
            tracing.RECORDER.queue(self.trace_id, rid, opens, self._trace)

    def kv_token_capacity(self) -> int:
        """Token capacity of this engine's KV plane."""
        if self.paged:
            return self.kv.n_pages * self.cfg.page_size
        return self.cfg.n_slots * self.cfg.max_len

    # -- intake -------------------------------------------------------------
    def validate(self, req: Request) -> None:
        """Raise if this engine could never serve ``req``."""
        if req.prompt is None or len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) >= self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"leaves no room to generate within "
                f"max_len={self.cfg.max_len}"
            )
        if not self.paged:
            return
        # the request must fit the pool *alone*, so preemption can
        # always drain the pool far enough for someone to finish
        need = -(-min(len(req.prompt) + req.l_out, self.cfg.max_len)
                 // self.cfg.page_size)
        if need > self.kv.n_pages:
            raise ValueError(
                f"request {req.rid}: needs up to {need} pages but the "
                f"pool has {self.kv.n_pages}; raise n_pages or "
                f"max_len/page_size"
            )

    def submit(self, req: Request) -> None:
        self.validate(req)
        if req.generated is None:
            req.generated = []
        if req.arrival is None:
            req.arrival = self.clock
        if not req.l_in:
            req.l_in = len(req.prompt)
        req.state = RequestState.ADMITTED
        req.admit_seq = self._seq
        self._seq += 1
        self.queue.append(req)
        self._trace_queue(req.rid, opens=True)

    # -- one engine step ------------------------------------------------------
    def step(self) -> dict:
        """Run one prefill (chunk) or one decode dispatch; returns event
        info (``kind``: prefill_chunk | prefill | decode | idle)."""
        tr = self._trace = tracing.begin(self.trace_id)
        if tr is None:
            return self._step()
        ev = None
        try:
            ev = self._step()
            return ev
        finally:
            self._trace = None
            tr.end(ev)

    def _step(self) -> dict:
        if self.paged:
            return self._step_paged()
        admitted = self._admit()
        if admitted:
            return self._prefill(admitted)
        if self.active:
            return self._decode_step()
        return {"kind": "idle"}

    # ==========================================================================
    # Paged / chunked plane
    # ==========================================================================
    def _step_paged(self) -> dict:
        want_prefill = bool(
            self.prefilling or (self.queue and self.slots.n_free)
        )
        if want_prefill and (not self.active or self._turn == "prefill"):
            ev = self._chunk_prefill_step()
            if ev is not None:
                self._turn = "decode"
                return ev
        if self.active:
            self._turn = "prefill"
            return self._decode_paged()
        if want_prefill:
            # decode drained while budget said "wait": force progress
            ev = self._chunk_prefill_step(force=True)
            if ev is not None:
                return ev
        return {"kind": "idle"}

    def _chunk_budget(self, force: bool) -> int:
        """Eq. 5: prompt tokens this step such that the prefill stall,
        amortized over decode iterations, keeps the tightest TPOT."""
        budget = self.cfg.chunk_size
        if force or not (self.cfg.slo_aware and self.active
                         and self.profiler.fitted):
            return budget
        cur_lens = [int(self.pos[s]) for s in self.active]
        e_d = self.profiler.decode_step_time(cur_lens)
        tightest_tpot = min(
            [r.tpot_slo for r in self.active.values()]
            + [r.tpot_slo for r in self.prefilling.values()]
            + [r.tpot_slo for r in self.queue[: self.slots.n_free]]
        )
        ttfts = ([r.ttft_slo for r in self.prefilling.values()]
                 + [r.ttft_slo for r in self.queue[: self.slots.n_free]])
        tightest_ttft = min(ttfts) if ttfts else 10.0
        n = ntoken_limit(tightest_ttft, tightest_tpot, e_d, self.profiler)
        return min(budget, n)

    def _chunk_prefill_step(self, force: bool = False) -> Optional[dict]:
        cfg = self.cfg
        while (self.queue and self.slots.n_free
               and len(self.prefilling) < cfg.prefill_batch):
            r = self.queue.pop(0)
            s = self.slots.alloc(r)
            r.slot = s
            # prefix-cache hit: the slot's table starts at the shared
            # pages and prefill resumes from the hit offset
            r.prefill_progress = self.kv.lookup_prefix(s, r.prompt)
            r.prefix_hit_tokens = r.prefill_progress
            r.state = RequestState.PREFILLING
            self.prefilling[s] = r
            self._rid_slot[r.rid] = s
            self._trace_queue(r.rid, opens=False)
        if not self.prefilling:
            return None
        budget = self._chunk_budget(force)
        if budget <= 0:
            return None  # no decode slack: let decode run this step

        takes: dict[int, int] = {}
        rem = budget
        # admission order (dict insertion), not slot id
        for s, r in self.prefilling.items():
            take = min(len(r.prompt) - r.prefill_progress, cfg.chunk_size,
                       rem)
            if take > 0 and not self.kv.ensure(s, r.prefill_progress + take):
                take = 0  # page pool dry: wait for reclamation
            takes[s] = take
            rem -= take
        if not any(takes.values()):
            if not self.active and len(self.prefilling) > 1:
                # pool dry with nothing decoding: recompute-preempt the
                # youngest prefill so the oldest can make progress
                oldest = min(self.prefilling,
                             key=lambda s: self.prefilling[s].admit_seq)
                self._preempt_youngest(exclude=oldest)
            return None

        tokens = np.zeros((cfg.n_slots, cfg.chunk_size), np.int32)
        start = np.array(self.pos)  # decode rows: frozen at cur pos
        lens = np.zeros((cfg.n_slots,), np.int32)
        for s, r in self.prefilling.items():
            t = takes[s]
            tokens[s, :t] = r.prompt[r.prefill_progress: r.prefill_progress + t]
            start[s] = r.prefill_progress
            lens[s] = t

        attrs = {}
        if self._trace is not None:
            # every lane scores the table's whole width of key positions
            attrs = {"pairs": tokens.size * self.kv.max_pages * cfg.page_size,
                     "pairs_needed": int(sum(
                         t * int(start[s]) + t * (t + 1) // 2
                         for s, t in takes.items()))}
        (logits, self.caches), dt = self._timed(
            lambda: self.model.chunk_step(
                self.caches, self.kv.device_table(), self._tensor(tokens),
                self._tensor(start), self._tensor(lens)),
            lanes=tokens.size, **attrs)
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        self.clock += dt
        self.n_dispatches += 1
        chunk_lens = [t for t in takes.values() if t > 0]
        self.profiler.observe_prefill(chunk_lens, dt)
        self.n_prefill_tokens += int(sum(chunk_lens))

        n_done = 0
        tok_ev: list[tuple] = []  # (rid, token, t) stream events
        for s, r in list(self.prefilling.items()):
            r.prefill_progress += takes[s]
            if takes[s] > 0 and r.prefill_progress >= len(r.prompt):
                # the slot's full-page prefix span is now immutable KV:
                # publish it so later same-prefix prompts hit
                self.kv.publish_prefix(s, r.prompt)
                tok = int(nxt[s])
                if r.first_token_time is None:
                    r.first_token_time = self.clock
                r.generated.append(tok)
                r.tokens_done = len(r.generated)
                tok_ev.append((r.rid, tok, self.clock))
                self.pos[s] = len(r.prompt)
                self.last_token[s] = tok
                self._host_state_dirty = True
                del self.prefilling[s]
                done = self._is_done(r, s)
                if self.park_on_prefill and not done:
                    self.parked[s] = r
                else:
                    r.state = RequestState.DECODING
                    self.active[s] = r
                n_done += 1
        self._retire()
        return {"kind": "prefill_chunk", "tokens": int(sum(chunk_lens)),
                "n_seqs": len(chunk_lens), "n_completed": n_done,
                "time": dt, "token_events": tok_ev}

    def _preempt_youngest(self, exclude: int) -> bool:
        """Recompute preemption: evict the youngest request — release
        its pages, fold its generated tokens into the prompt and requeue
        it at the head.  Deterministic greedy decode makes it exact."""
        in_flight = {**self.active, **self.prefilling}
        candidates = [s for s in in_flight if s != exclude]
        if not candidates:
            return False
        v = max(candidates, key=lambda s: in_flight[s].admit_seq)
        r = self.active.pop(v, None) or self.prefilling.pop(v)
        self._rid_slot.pop(r.rid, None)
        self._release_slot(v)
        self._trace_queue(r.rid, opens=True)
        if r.generated:
            r.prompt = np.concatenate([
                np.asarray(r.prompt, np.int32),
                np.asarray(r.generated, np.int32),
            ])
        r.prefill_progress = 0
        r.slot = None
        r.state = RequestState.PREEMPTED
        self.queue.insert(0, r)
        return True

    def _release_slot(self, s: int) -> None:
        """Free every per-slot resource (pages, cache row, batch row)."""
        if self.kv is not None:
            self.kv.release(s)
        self.caches = clear_rows(self.caches, self.axes, [s])
        self.slots.free(s)
        self.pos[s] = 0
        self.last_token[s] = 0
        self._host_state_dirty = True

    def evict(self, s: int) -> Optional[Request]:
        """Drop the request in slot ``s`` from the engine entirely (its
        KV now lives elsewhere).  Unlike preemption, it is not
        re-queued."""
        r = (self.active.pop(s, None) or self.prefilling.pop(s, None)
             or self.parked.pop(s, None))
        if r is None:
            return None
        self._rid_slot.pop(r.rid, None)
        self._release_slot(s)
        r.slot = None
        return r

    # -- P/D hand-off ---------------------------------------------------------
    def _slot_of(self, rid: int) -> Optional[int]:
        """O(1) lookup via the rid -> slot index kept in sync by the
        alloc (admission/prefill/import) and release (retire/evict/
        preempt) paths — no three-pool linear scan per export."""
        return self._rid_slot.get(rid)

    def exportable(self, rid: int) -> bool:
        """True while ``rid``'s KV is resident in a state export_kv
        accepts: parked or mid-decode, not still prefilling and not
        recompute-preempted back to the queue.  The source-side guard
        for in-flight migrations — a transfer scheduled while the
        request was exportable may land after it finished or was
        preempted, and then there is nothing left to move."""
        s = self._slot_of(rid)
        return self.paged and s is not None and s not in self.prefilling

    def export_kv(self, rid: int) -> KVPayload:
        """Materialize request ``rid``'s cache + generation state for a
        hand-off.  The request must have completed prefill (parked, or
        mid-decode); its pages stay resident until ``evict``."""
        if not self.paged:
            raise RuntimeError(
                "export_kv requires the paged plane (slot-plane caches "
                "have no page-granular hand-off)"
            )
        s = self._rid_slot.get(rid)
        if s is None:
            raise KeyError(f"request {rid} is not resident on this engine")
        if s in self.prefilling:
            raise RuntimeError(
                f"request {rid} has not finished prefill; its cache is "
                f"not yet a complete prefix"
            )
        n = int(self.pos[s])
        ids = self._tensor(np.asarray(self.kv.pages_of(s), np.int32))
        payload_kv = gather_slot_kv(self.caches, self.axes, s, ids, n)
        r = self.parked.get(s) or self.active.get(s)
        return KVPayload(rid=rid, n_tokens=n,
                         last_token=int(self.last_token[s]),
                         prefill_progress=r.prefill_progress,
                         kv=payload_kv)

    def import_kv(self, payload: KVPayload, req: Request) -> bool:
        """Install a migrated cache and join ``req`` to the decode batch.
        Allocates a slot + pages (the page size may differ from the
        source's); False if the engine cannot place it right now."""
        if not self.paged:
            raise RuntimeError("import_kv requires the paged plane")
        s = self.slots.alloc(req)
        if s is None:
            return False
        if not self.kv.ensure(s, payload.n_tokens):
            self.slots.free(s)
            return False
        ids = self._tensor(np.asarray(self.kv.pages_of(s), np.int32))
        self.caches = scatter_slot_kv(self.caches, self.axes, s, ids,
                                      payload.kv)
        if req.generated is None:
            req.generated = []
        req.slot = s
        req.prefill_progress = payload.prefill_progress
        req.state = RequestState.DECODING
        req.admit_seq = self._seq  # fresh age on this engine
        self._seq += 1
        self.pos[s] = payload.n_tokens
        self.last_token[s] = payload.last_token
        self._host_state_dirty = True
        self.active[s] = req
        self._rid_slot[req.rid] = s
        return True

    def kv_bytes_of(self, rid: int) -> Optional[float]:
        """Exact byte size export_kv would materialize for ``rid`` —
        from cache shapes, nothing gathered."""
        s = self._rid_slot.get(rid)
        if s is None or not self.paged:
            return None
        n = int(self.pos[s])
        total = 0.0
        for seg, ax in zip(self.caches, self.axes):
            for name, leaf in seg.items():
                if ax[name] is None:   # page pool: n tokens' worth of K/V
                    n_pages, _, ps, _ = leaf.shape[-4:]
                    total += (leaf.numel() / (n_pages * ps)
                              * leaf.element_size() * n)
                else:                  # per-slot state: one batch row
                    total += (leaf.numel() // leaf.shape[ax[name]]
                              * leaf.element_size())
        return float(total)

    # -- fused decode blocks ---------------------------------------------------
    def _decode_block_k(self) -> int:
        """Decode iterations to fuse this step: the config ceiling,
        collapsed to 1 while prefill work is pending (keeps the Eq. 5
        chunk/decode interleave), capped by the smallest remaining
        output budget and max_len room, rounded down to a power of two."""
        cfg = self.cfg
        k = max(1, int(cfg.decode_block))
        if k == 1 or not self.active:
            return 1
        if self.prefilling or self.queue:
            return 1
        for s, r in self.active.items():
            k = min(k, max(1, r.l_out - len(r.generated)),
                    max(1, cfg.max_len - 1 - int(self.pos[s])))
        return 1 << (k.bit_length() - 1)

    def _fits(self, grow: dict) -> bool:
        """Whether the pool can give every active slot ``s`` room for
        ``grow[s]`` more tokens (capped at max_len).  Unreferenced
        cached prefix pages count as free: ``ensure`` evicts them on
        demand when the reservation is drawn down."""
        ps = self.cfg.page_size
        need = 0
        for s in self.active:
            tgt = min(int(self.pos[s]) + grow[s], self.cfg.max_len)
            need += max(0, -(-tgt // ps) - self.kv.n_pages_held(s))
        return need <= self.kv.n_available_pages

    def _fit_block_k(self, k: int) -> int:
        """Halve K until pre-reserving pages for K new tokens per active
        slot fits the pool; at 1 the preempt-youngest fallback takes
        over."""
        while k > 1 and not self._fits(dict.fromkeys(self.active, k)):
            k //= 2
        return k

    def _device_state(self) -> tuple:
        """(last_token, pos) on the device: the previous block's final
        state, unless a host-side mutation forced a re-upload."""
        if self._dev_state is None or self._host_state_dirty:
            self._dev_state = (self._tensor(self.last_token),
                               self._tensor(self.pos))
            self._host_state_dirty = False
        return self._dev_state

    def _decode_graph(self) -> Optional[_DecodeGraph]:
        """The captured decode iteration this dispatch replays, captured
        now if this engine has none yet; None where
        decode runs eagerly: the CPU, the slot plane, a model on its plain
        routes (its paged write filters on the host), ``_forced_eager``."""
        if not (self.paged and self.device.type == "cuda"
                and self.model.use_kernels) or _EAGER_ONLY[0]:
            return None
        if self._graph is None:
            self._graph = _DecodeGraph(self)
        return self._graph

    def _replay_decode(self, g: _DecodeGraph, alive, rem, k: int):
        """The graph path of a decode dispatch: this dispatch's ``alive``
        and ``rem`` into the graph's inputs, with ``last`` / ``pos`` only
        after a host-side change, the page table if it changed, then
        ``k`` replays.  Returns the (n_slots, k) tokens and emitting rows
        for k > 1, else None (the token is ``g.state[0]``)."""
        h = g.host
        h[2], h[3] = alive, rem
        first = 2
        if self._host_state_dirty or self._dev_state is not g.views:
            h[0], h[1] = self.last_token, self.pos
            first = 0
        # non-blocking from pageable memory: staged before it returns
        g.state[first:].copy_(torch.from_numpy(h[first:]), non_blocking=True)
        self.kv.device_table()
        out = None
        if k > 1:
            n = self.cfg.n_slots
            out = (torch.empty((n, k), dtype=torch.int32, device=self.device),
                   torch.empty((n, k), dtype=torch.bool, device=self.device))
        with torch.cuda.device(self.device):
            g.replay(k, *(out or ()))
        self._dev_state = g.views
        self._host_state_dirty = False
        return out

    def _decode_rows(self) -> tuple:
        """The decode batch's rows: alive (bool), remaining output budget
        and the starting position of each active slot."""
        alive = np.zeros(self.cfg.n_slots, bool)
        rem = np.zeros(self.cfg.n_slots, np.int32)
        pos0: dict[int, int] = {}
        for s, r in self.active.items():
            alive[s] = True
            rem[s] = r.l_out - len(r.generated)
            pos0[s] = int(self.pos[s])
        return alive, rem, pos0

    def warm_decode_blocks(self) -> None:
        """Run one decode block per power-of-two K up to ``decode_block``
        and, with speculation on, one verify pass per power-of-two
        proposal width up to ``max_spec_len``, with an all-frozen batch,
        outputs discarded — the counterpart of the JAX engine's
        compile-ahead, so that first launches and allocations land in no
        measured step — then captures the decode graph where the engine
        replays one.  For an idle engine: a frozen paged row drops its
        writes, but a frozen slot-plane row rewrites its position-0
        entry, so the slot plane's rows are cleared afterwards."""
        if self.queue or self.active or self.prefilling or self.parked:
            raise RuntimeError("warm_decode_blocks needs an idle engine")
        cfg = self.cfg
        zeros = self._tensor(np.zeros(cfg.n_slots, np.int32))
        alive = self._tensor(np.zeros(cfg.n_slots, bool))
        state = (zeros, zeros, alive, zeros + 1, -1, cfg.max_len)
        k = 2
        while k <= max(1, cfg.decode_block):
            if self.paged:
                self.model.decode_block(
                    self.caches, self.kv.device_table(), *state, k=k)
            else:
                self.model.decode_block_slots(self.caches, *state, k=k)
            self._sync()
            k *= 2
        if cfg.spec_decode:
            # verify dispatches land in pow2 proposal-width buckets
            k = 1
            while True:
                props = self._tensor(np.zeros((cfg.n_slots, k), np.int32))
                self.model.spec_decode_block(
                    self.caches, self.kv.device_table(), *state, props,
                    zeros, k=k)
                self._sync()
                if k >= cfg.max_spec_len:
                    break
                k *= 2
        if not self.paged:
            self.caches = clear_rows(self.caches, self.axes,
                                     list(range(cfg.n_slots)))
        self._decode_graph()

    def _spec_history(self, r: Request) -> list[int]:
        """The request's true token sequence (prompt + generated).
        After a recompute preemption the prompt already contains the
        pre-preemption output, so slice to the original l_in."""
        n_in = r.l_in or len(r.prompt)
        return [int(t) for t in r.prompt[:n_in]] + [
            int(t) for t in r.generated
        ]

    def _spec_decode_step(self) -> Optional[dict]:
        """One propose-verify-accept speculative dispatch (paged plane).

        Per active lane: the SLO controller picks a depth from the
        request's TPOT slack, the n-gram drafter fills it (possibly with
        fewer tokens, possibly none — a zero-proposal lane rides along
        as a plain 1-token decode), one ``spec_decode_block`` scores
        everything, and rejected lanes' KV is rolled back by truncating
        the page table to the accepted position.  Returns None when
        nothing proposes or the page pool cannot cover the proposals
        even at depth 1 — the caller falls through to the plain
        block/per-token path.
        """
        cfg = self.cfg
        cur_lens = [int(self.pos[s]) for s in self.active]
        plen: dict[int, int] = {}
        drafts: dict[int, list[int]] = {}
        want_of: dict[int, int] = {}    # controller depth (telemetry)
        for s, r in self.active.items():
            cap = min(
                self._spec_cfg.max_spec_len,
                r.l_out - len(r.generated) - 1,   # lane 0 emits one
                cfg.max_len - 1 - int(self.pos[s]),  # KV write room
            )
            want = min(
                slo_spec_len(r.tpot_slo, self.profiler, cur_lens,
                             self._spec_cfg),
                cap,
            )
            want_of[s] = want
            d = self.drafter.propose(self._spec_history(r), want)
            drafts[s] = d
            plen[s] = len(d)
        if not any(plen.values()):
            return None
        # pre-reserve pages for every lane's verify writes (positions
        # pos .. pos+plen); halve all depths until the pool fits
        while not self._fits({s: p + 1 for s, p in plen.items()}):
            plen = {s: p // 2 for s, p in plen.items()}
            if not any(plen.values()):
                return None
        for s in self.active:
            ok = self.kv.ensure(
                s, min(int(self.pos[s]) + plen[s] + 1, cfg.max_len)
            )
            assert ok, "spec reservation failed after availability check"

        kmax = max(plen.values())
        kpad = 1 << (kmax - 1).bit_length()  # pow2 width bucket
        props = np.zeros((cfg.n_slots, kpad), np.int32)
        prop_lens = np.zeros(cfg.n_slots, np.int32)
        alive = np.zeros(cfg.n_slots, bool)
        rem = np.zeros(cfg.n_slots, np.int32)
        pos0: dict[int, int] = {}
        for s, r in self.active.items():
            alive[s] = True
            rem[s] = r.l_out - len(r.generated)
            pos0[s] = int(self.pos[s])
            d = drafts[s][: plen[s]]
            props[s, : len(d)] = d
            prop_lens[s] = len(d)

        last_d, pos_d = self._device_state()
        eos = -1 if cfg.eos_token is None else cfg.eos_token
        ((toks, valid, last_f, pos_f), self.caches), dt = self._timed(
            lambda: self.model.spec_decode_block(
                self.caches, self.kv.device_table(), last_d, pos_d,
                self._tensor(alive), self._tensor(rem), eos, cfg.max_len,
                self._tensor(props), self._tensor(prop_lens), k=kpad),
            lanes=cfg.n_slots * (kpad + 1))
        tk = toks.cpu().numpy()    # (n_slots, kpad+1)
        vd = valid.cpu().numpy()   # (n_slots, kpad+1) bool
        self.clock += dt
        self.n_dispatches += 1
        self.n_spec_dispatches += 1
        self.spec_depth_hist[kpad] = self.spec_depth_hist.get(kpad, 0) + 1
        self._dev_state = (last_f, pos_f)
        self._host_state_dirty = False

        t_start = self.clock - dt
        finish_at: dict[int, float] = {}
        tok_ev: list[tuple] = []
        n_emitted = 0
        for s, r in self.active.items():
            lanes = np.nonzero(vd[s])[0]
            emitted = [int(tk[s][i]) for i in lanes]
            accepted = max(0, len(emitted) - 1)
            self.n_spec_proposed += int(prop_lens[s])
            self.n_spec_accepted += accepted
            st = self.spec_task_stats.setdefault(
                r.task or "default",
                {"lanes": 0, "sum_want": 0, "sum_k": 0, "accepted": 0},
            )
            st["lanes"] += 1
            st["sum_want"] += want_of[s]   # controller's chosen depth
            st["sum_k"] += int(prop_lens[s])
            st["accepted"] += accepted
            if not emitted:
                continue
            r.generated.extend(emitted)
            r.tokens_done = len(r.generated)
            self.pos[s] += len(emitted)
            self.last_token[s] = emitted[-1]
            n_emitted += len(emitted)
            for tok, lane in zip(emitted, lanes):
                tok_ev.append(
                    (r.rid, tok, t_start + dt * (lane + 1) / (kpad + 1))
                )
            last_lane = int(lanes[-1])
            finish_at[s] = t_start + dt * (last_lane + 1) / (kpad + 1)
            # rollback: rejected lanes' KV past the accepted position
            # is dead weight — give whole pages back to the pool
            self.kv.truncate(s, int(self.pos[s]))
        # accepted-only Appendix-A attribution: trailing all-rejected
        # lanes are trimmed by observe_decode_block, so rejected
        # speculation never biases the Eq. 2 fit low
        self.profiler.observe_decode_block(
            [[pos0[s] + i for s in sorted(pos0) if vd[s, i]]
             for i in range(kpad + 1)], dt,
        )
        self.n_decode_tokens += n_emitted
        self._retire(finish_at)
        return {"kind": "decode", "n": len(pos0), "k": kpad + 1,
                "tokens": n_emitted, "time": dt, "spec": True,
                "token_events": tok_ev, "graph": False}

    def _decode_block_step(self, k: int) -> dict:
        """One fused K-iteration decode block: one dispatch and one host
        sync cover K tokens for every active slot, with stopping
        evaluated on the device."""
        cfg = self.cfg
        alive, rem, pos0 = self._decode_rows()
        g = self._decode_graph()
        if g is not None:
            (toks, valid), dt = self._timed(
                lambda: self._replay_decode(g, alive, rem, k),
                lanes=cfg.n_slots * k, graph=True)
        else:
            last_d, pos_d = self._device_state()
            eos = -1 if cfg.eos_token is None else cfg.eos_token
            state = (last_d, pos_d, self._tensor(alive), self._tensor(rem),
                     eos, cfg.max_len)

            def call():
                if self.paged:
                    return self.model.decode_block(
                        self.caches, self.kv.device_table(), *state, k=k)
                return self.model.decode_block_slots(self.caches, *state,
                                                     k=k)

            ((toks, valid, last_f, pos_f), self.caches), dt = self._timed(
                call, lanes=cfg.n_slots * k)
            self._dev_state = (last_f, pos_f)
            self._host_state_dirty = False
        tk = toks.cpu().numpy()    # (n_slots, K)
        vd = valid.cpu().numpy()   # (n_slots, K) bool
        self.clock += dt
        self.n_dispatches += 1
        self.decode_block_hist[k] = self.decode_block_hist.get(k, 0) + 1
        self._count_decode(k, g is not None)

        t_start = self.clock - dt
        finish_at: dict[int, float] = {}
        tok_ev: list[tuple] = []
        n_emitted = 0
        for s, r in self.active.items():
            lanes = np.nonzero(vd[s])[0]
            emitted = [int(tk[s][i]) for i in lanes]
            if not emitted:
                continue
            r.generated.extend(emitted)
            r.tokens_done = len(r.generated)
            self.pos[s] += len(emitted)
            self.last_token[s] = emitted[-1]
            n_emitted += len(emitted)
            # per-token stamps interpolate inside the block
            for tok, lane in zip(emitted, lanes):
                tok_ev.append((r.rid, tok, t_start + dt * (lane + 1) / k))
            finish_at[s] = t_start + dt * (int(lanes[-1]) + 1) / k
        self.profiler.observe_decode_block(
            [[pos0[s] + i for s in sorted(pos0) if vd[s, i]]
             for i in range(k)], dt,
        )
        self.n_decode_tokens += n_emitted
        self._retire(finish_at)
        return {"kind": "decode", "n": len(pos0), "k": k,
                "tokens": n_emitted, "time": dt, "token_events": tok_ev,
                "graph": g is not None}

    def _decode_paged(self) -> dict:
        cfg = self.cfg
        if (cfg.spec_decode and self.active
                and not self.prefilling and not self.queue):
            # speculate only when decode owns the step (pending prefill
            # keeps the Eq. 5 chunk/decode interleave, same as the
            # decode-block collapse-to-1 rule)
            ev = self._spec_decode_step()
            if ev is not None:
                return ev
        k = self._fit_block_k(self._decode_block_k())
        # page pre-reservation: every active slot gets room for K new
        # tokens; at K == 1 preempt-youngest reclaims pages
        for s in list(self.active):
            if s not in self.active:  # evicted by an earlier preemption
                continue
            while not self.kv.ensure(s, min(int(self.pos[s]) + k,
                                            cfg.max_len)):
                if not self._preempt_youngest(exclude=s):
                    raise RuntimeError(
                        "page pool exhausted with a single request in "
                        "flight — submit() sizing guard violated"
                    )
        if k > 1:
            return self._decode_block_step(k)
        g = self._decode_graph()
        if g is not None:
            alive, rem, _ = self._decode_rows()
            _, dt = self._timed(lambda: self._replay_decode(g, alive, rem, 1),
                                lanes=cfg.n_slots, graph=True)
            nxt = g.state[0].cpu().numpy()   # read before the next replay
        else:
            lens = np.zeros((cfg.n_slots,), np.int32)
            for s in self.active:
                lens[s] = 1  # the new token lands at position pos[s]
            (logits, self.caches), dt = self._timed(
                lambda: self.model.chunk_step(
                    self.caches, self.kv.device_table(),
                    self._tensor(self.last_token[:, None]),
                    self._tensor(self.pos), self._tensor(lens)),
                lanes=cfg.n_slots)
            nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
            self._host_state_dirty = True
        self.clock += dt
        self.profiler.observe_decode(
            [int(self.pos[s]) for s in sorted(self.active)], dt)
        return self._finish_per_token_decode(nxt, dt, graph=g is not None)

    # ==========================================================================
    # Slot plane (monolithic prefill)
    # ==========================================================================
    def _admit(self) -> list[Request]:
        """Eq. 5 at the engine boundary: the queue head, up to the free
        slots and ``prefill_batch``, cut to the prompt tokens a prefill
        may take without breaking the tightest TPOT."""
        free = self.slots.n_free
        if not free or not self.queue:
            return []
        take = self.queue[: min(free, self.cfg.prefill_batch)]
        if self.cfg.slo_aware and self.active:
            fitted = self.profiler.fitted
            cur_lens = [int(self.pos[s]) for s in self.slots.active_slots()]
            e_d = self.profiler.decode_step_time(cur_lens) if fitted else 0.0
            tightest_tpot = min([r.tpot_slo for r in self.active.values()]
                                + [r.tpot_slo for r in take])
            tightest_ttft = min(r.ttft_slo for r in take)
            budget = ntoken_limit(tightest_ttft, tightest_tpot, e_d,
                                  self.profiler) if fitted else 10 ** 9
            out, used = [], 0
            for r in take:
                if used + len(r.prompt) <= budget:
                    out.append(r)
                    used += len(r.prompt)
            take = out
        for r in take:
            self.queue.remove(r)
            self._trace_queue(r.rid, opens=False)
        return take

    @staticmethod
    def _pad_to(n: int) -> int:
        """Prompt batches pad to a power of two from 8 up (the JAX
        engine's bound on recompiles, kept so both engines run the same
        shapes)."""
        p = 8
        while p < n:
            p *= 2
        return p

    def _prefill(self, reqs: Sequence[Request]) -> dict:
        b = len(reqs)
        max_l = self._pad_to(max(len(r.prompt) for r in reqs))
        tokens = np.zeros((b, max_l), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        (logits, cache), dt = self._timed(
            lambda: self.model.prefill(self._tensor(tokens), self._tensor(lens),
                                       cache_len=self.cfg.max_len),
            lanes=tokens.size, tokens=int(lens.sum()))
        next_tokens = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        self.clock += dt
        self.n_dispatches += 1
        self.profiler.observe_prefill([len(r.prompt) for r in reqs], dt)
        self.n_prefill_tokens += int(lens.sum())

        slots = []
        tok_ev: list[tuple] = []
        for i, r in enumerate(reqs):
            s = self.slots.alloc(r)
            assert s is not None
            r.slot = s
            r.prefill_progress = len(r.prompt)
            if r.first_token_time is None:
                r.first_token_time = self.clock
            r.generated.append(int(next_tokens[i]))
            r.tokens_done = len(r.generated)
            tok_ev.append((r.rid, int(next_tokens[i]), self.clock))
            r.state = RequestState.DECODING
            self.active[s] = r
            self._rid_slot[r.rid] = s
            self.pos[s] = int(lens[i])
            self.last_token[s] = int(next_tokens[i])
            slots.append(s)
        self._host_state_dirty = True
        self.caches = insert_rows(self.caches, cache, self.axes, slots)
        self._retire()
        return {"kind": "prefill", "n": b, "time": dt,
                "token_events": tok_ev}

    def _decode_step(self) -> dict:
        k = self._decode_block_k()
        if k > 1:
            return self._decode_block_step(k)
        (logits, self.caches), dt = self._timed(
            lambda: self.model.decode_step(
                self.caches, self._tensor(self.last_token),
                self._tensor(self.pos)),
            lanes=self.cfg.n_slots)
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        self.clock += dt
        self._host_state_dirty = True
        self.profiler.observe_decode(
            [int(self.pos[s]) for s in self.slots.active_slots()], dt)
        return self._finish_per_token_decode(nxt, dt)

    def _finish_per_token_decode(self, nxt, dt: float,
                                 graph: bool = False) -> dict:
        """K == 1 tail of both planes: append the sampled token per active slot,
        advance host state, account telemetry and retire.  An eager
        caller has marked the device's (last, pos) stale; a replay left
        it equal to the host's new state."""
        n_tok = len(self.active)
        tok_ev: list[tuple] = []
        for s, r in list(self.active.items()):
            self.pos[s] += 1
            tok = int(nxt[s])
            r.generated.append(tok)
            r.tokens_done = len(r.generated)
            self.last_token[s] = tok
            tok_ev.append((r.rid, tok, self.clock))
        self.n_dispatches += 1
        self.decode_block_hist[1] = self.decode_block_hist.get(1, 0) + 1
        self._count_decode(1, graph)
        self.n_decode_tokens += n_tok
        self._retire()
        return {"kind": "decode", "n": n_tok, "k": 1,
                "tokens": n_tok, "time": dt, "token_events": tok_ev,
                "graph": graph}

    def _count_decode(self, k: int, graph: bool) -> None:
        self.decode_iters += k
        if graph:
            self.decode_graph_iters += k

    # -- completion ------------------------------------------------------------
    def _is_done(self, r: Request, s: int) -> bool:
        """The one completion predicate (mirrored on the device by
        ``Model._decode_block_body``): output cap reached, EOS emitted,
        or no room for another token's KV within max_len."""
        eos = (self.cfg.eos_token is not None and r.generated
               and r.generated[-1] == self.cfg.eos_token)
        return bool(len(r.generated) >= r.l_out or eos
                    or int(self.pos[s]) + 1 >= self.cfg.max_len)

    def _retire(self, finish_at: Optional[dict] = None) -> None:
        """Move completed requests out of the decode batch; ``finish_at``
        carries interpolated stamps from a fused block."""
        done = []
        for s, r in list(self.active.items()):
            if self._is_done(r, s):
                r.finish_time = (finish_at or {}).get(s, self.clock)
                r.state = RequestState.FINISHED
                self.finished.append(r)
                done.append(s)
                del self.active[s]
                self._rid_slot.pop(r.rid, None)
        for s in done:
            self._release_slot(s)

    # -- drive to completion ------------------------------------------------------
    def run_until_done(self, max_steps: int = 10_000) -> list[Request]:
        """Step until idle; returns the requests finished during the call."""
        mark = len(self.finished)
        for _ in range(max_steps):
            if not self.queue and not self.active and not self.prefilling:
                break
            self.step()
        return self.finished[mark:]

    def fit_profiler(self) -> bool:
        tr = tracing.begin(self.trace_id, "engine.fit_profiler", parts=False)
        fitted = self.profiler.fit(min_samples=4)
        if tr is not None:
            tr.end(None)
        return fitted

    def release_weights(self) -> None:
        """Drop this replica's model (scale-in) so its device memory is
        reclaimable.  The engine must not step again afterwards."""
        if self.queue or self.active or self.prefilling or self.parked:
            raise RuntimeError(
                "release_weights on an engine that still holds work; "
                "drain before scale-in"
            )
        self.model = None
        self._graph = None
