"""The port's ``Cluster(backend="engine")`` against the JAX package's.

Ports of the engine-plane cases of ``test_backend_unified.py``,
``test_pd_engine.py``, ``test_fast_scaling.py`` and
``test_live_migration.py``: colocated and P/D serving, the slot-plane
fallback, d2d scale-out and scale-in, scale-from-zero to disk, donor
choice and live evacuation.  Both clusters serve the smoke qwen7b with
the JAX package's weights for seed 0 (the port's through
``convert.params_from_jax``), in f32 on the CPU.  Each case also asserts
that every request generated the JAX ``Cluster``'s tokens on the same
configuration and workload; SLO numbers are not compared, since both
clocks are measured wall time.  Replicas' weight ownership is checked as
disjoint tensor storage.  Also: the torch checkpoint format, the
WeightManager's transports, and the device rule (the engine plane needs
a card unless it is given ``device="cpu"``; the sim plane needs none).
"""

import dataclasses
import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.dispatcher import Dispatcher  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.scaler import ScaleAction, Scaler  # noqa: E402
from repro_torch.core.tlmanager import TLManager  # noqa: E402
from repro_torch.distributed.checkpoint import (  # noqa: E402
    all_steps,
    checkpoint_nbytes,
    latest_step,
    load_checkpoint,
    load_latest,
    save_checkpoint,
)
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.backend import (  # noqa: E402
    Backend,
    EngineWorker,
    WorkerBase,
)
from repro_torch.serving.cluster import (  # noqa: E402
    Cluster,
    ClusterConfig,
    replica_model,
)
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
)
from repro_torch.serving.session import ServingSession  # noqa: E402
from repro_torch.serving.weights import STRATEGIES, WeightManager  # noqa

SMOKE = get_smoke_config("qwen7b")


@pytest.fixture(scope="module")
def seed_params():
    """The JAX package's smoke qwen7b weights for seed 0 — what its
    engine-plane Cluster draws — in the port's names."""
    tree = jax_build(jax_smoke("qwen7b")).init(jax.random.key(0))
    return params_from_jax(jax.tree.map(np.asarray, tree), SMOKE)


# ---------------------------------------------------------------------------
# Scenarios, built in either package
# ---------------------------------------------------------------------------

def _pkg(name: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        smoke=mod("configs").get_smoke_config("qwen7b"),
        Cluster=mod("serving.cluster").Cluster,
        ClusterConfig=mod("serving.cluster").ClusterConfig,
        EngineConfig=mod("serving.engine").EngineConfig,
        ScalerConfig=mod("core.scaler").ScalerConfig,
        Request=mod("core.request").Request,
        TASKS=mod("core.request").TASKS,
        TWO_TASK_SET=mod("core.request").TWO_TASK_SET,
        PrioritySLOMapper=mod("core.slo_mapper").PrioritySLOMapper,
        bands_from_tasks=mod("core.slo_mapper").bands_from_tasks,
    )


def _multi_slo_workload(m, n=12, seed=0):
    """Two task classes with distinct SLOs and priorities, sized for a
    reduced engine (prompts of 4-13 tokens, 2-5 output tokens)."""
    rng = np.random.default_rng(seed)
    classes = [("chat", 0.8, 0.25, 0), ("doc", 4.0, 0.6, 1)]
    reqs, t = [], 0.0
    for i in range(n):
        name, ttft, tpot, prio = classes[i % 2]
        t += float(rng.exponential(0.05))
        reqs.append(m.Request(rid=i, task=name, arrival=t,
                              l_in=int(rng.integers(4, 14)),
                              l_out=int(rng.integers(2, 6)),
                              ttft_slo=ttft, tpot_slo=tpot, priority=prio))
    return reqs


def _pd_workload(m, n=8, seed=0):
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.05))
        reqs.append(m.Request(rid=i, task="chat" if i % 2 else "doc",
                              arrival=t, l_in=int(rng.integers(4, 14)),
                              l_out=int(rng.integers(2, 6)),
                              ttft_slo=2.0, tpot_slo=0.6))
    return reqs


def _evac_workload(m):
    rng = np.random.default_rng(0)
    reqs, t = [], 0.0
    for i in range(6):
        t += float(rng.exponential(0.02))
        reqs.append(m.Request(rid=i, task="chat", arrival=t,
                              l_in=int(rng.integers(8, 16)), l_out=16,
                              ttft_slo=5.0, tpot_slo=2.0))
    return reqs


def _colocated_cfg(m, **kw):
    kw.setdefault("engine", m.EngineConfig(n_slots=4, max_len=48,
                                           prefill_batch=2))
    return m.ClusterConfig(model=m.smoke, backend="engine", n_workers=1,
                           policy="hyperflexis", seed=0, **kw)


def _pd_engine(m, **kw):
    return m.EngineConfig(**{**dict(n_slots=4, max_len=48, prefill_batch=2,
                                    page_size=8, chunk_size=16), **kw})


def _pd_cfg(m, **kw):
    kw.setdefault("engine", _pd_engine(m))
    return m.ClusterConfig(model=m.smoke, backend="engine",
                           policy="hyperflexis", mode="pd", n_prefill=1,
                           n_decode=1, seed=0, **kw)


def _mapper(m):
    return m.PrioritySLOMapper(
        m.bands_from_tasks([m.TASKS[t] for t in m.TWO_TASK_SET]))


SCENARIOS = {
    "multi_slo": lambda m: (_colocated_cfg(
        m, slo_mapper=_mapper(m), scaling=True,
        scaler=m.ScalerConfig(max_workers=1, min_workers=1)),
        _multi_slo_workload(m, 12)),
    "colocated_6": lambda m: (_colocated_cfg(m), _multi_slo_workload(m, 6)),
    "colocated_4": lambda m: (_colocated_cfg(m), _multi_slo_workload(m, 4)),
    "slot_plane": lambda m: (_colocated_cfg(m, engine=m.EngineConfig(
        n_slots=4, max_len=32, prefill_batch=2, paged=False)),
        _multi_slo_workload(m, 6)),
    "pd_scaling": lambda m: (_pd_cfg(
        m, scaling=True, scaler=m.ScalerConfig(max_workers=2,
                                               min_workers=1)),
        _pd_workload(m)),
    "pd_one_slot": lambda m: (_pd_cfg(
        m, engine=_pd_engine(m, n_slots=1, prefill_batch=1),
        drain_timeout=10.0), _pd_workload(m, 4)),
    "pd": lambda m: (_pd_cfg(m), _pd_workload(m)),
    "pd_6": lambda m: (_pd_cfg(m), _pd_workload(m, 6)),
    "pd_colocated": lambda m: (_colocated_cfg(m, engine=_pd_engine(m)),
                               _pd_workload(m)),
    "evac_base": lambda m: (m.ClusterConfig(
        model=m.smoke, backend="engine", policy="rr", n_workers=2, seed=0,
        engine=_pd_engine(m, max_len=64, decode_block=2)),
        _evac_workload(m)),
}

_JAX_TOKENS: dict = {}


def jax_tokens(name: str) -> list:
    """Every request's tokens from the JAX package's Cluster on the
    scenario (run once per module)."""
    if name not in _JAX_TOKENS:
        cfg, reqs = SCENARIOS[name](_pkg("repro"))
        res = _pkg("repro").Cluster(cfg).run(reqs)
        assert res.metrics.n_finished == len(reqs)
        _JAX_TOKENS[name] = [list(r.generated) for r in reqs]
    return _JAX_TOKENS[name]


def _port(name: str, seed_params, **cfg_kw):
    """(Cluster, requests) of the scenario in the port, on the CPU."""
    cfg, reqs = SCENARIOS[name](_pkg("repro_torch"))
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    return Cluster(cfg, device="cpu", seed_params=seed_params), reqs


def _tokens(reqs) -> list:
    return [list(r.generated) for r in reqs]


def _storages(model) -> set:
    return {p.untyped_storage().data_ptr() for p in model.parameters()
            if p.numel()}


def _disjoint(*models_or_dicts) -> bool:
    seen: set = set()
    for x in models_or_dicts:
        ptrs = (_storages(x) if isinstance(x, torch.nn.Module) else
                {t.untyped_storage().data_ptr() for t in x.values()})
        if ptrs & seen:
            return False
        seen |= ptrs
    return True


# ---------------------------------------------------------------------------
# test_backend_unified.py
# ---------------------------------------------------------------------------

def test_engine_backed_cluster_end_to_end_multi_slo(seed_params):
    cluster, reqs = _port("multi_slo", seed_params)
    mapper = cluster.cfg.slo_mapper
    assert isinstance(cluster.policy.dispatcher, Dispatcher)
    assert isinstance(cluster.scaler, Scaler)
    assert all(isinstance(w, EngineWorker) for w in cluster.workers)

    res = cluster.run(reqs)
    m = res.metrics
    assert m.n_finished == m.n_total == len(reqs)
    for r in reqs:
        assert r.state == RequestState.FINISHED
        assert r.finish_time is not None and r.first_token_time is not None
        assert len(r.generated) == r.l_out
        assert r.tokens_done == r.l_out
        assert r.ttft is not None and r.ttft >= 0.0
        band = mapper.bands[r.priority]
        assert band.min_ttft - 1e-9 <= r.ttft_slo <= band.max_ttft + 1e-9
    assert cluster.fitted.n_samples() > 0
    assert cluster.workers[0].engine.profiler is cluster.fitted
    assert set(m.per_task) == {"chat", "doc"}
    for v in m.per_task.values():
        assert {"ttft_attainment", "tpot_attainment"} <= set(v)
    assert _tokens(reqs) == jax_tokens("multi_slo")


def test_sim_and_engine_runmetrics_schema_identical(seed_params):
    from repro_torch.serving.workload import poisson_workload

    sim = Cluster(ClusterConfig(model=get_config("qwen7b"), n_workers=1,
                                policy="hyperflexis", seed=0)).run(
        poisson_workload(["gsm8k"], qps=16, n_per_task=5, seed=0))
    cluster, reqs = _port("colocated_6", seed_params)
    eng = cluster.run(reqs)
    a = dataclasses.asdict(sim.metrics)
    b = dataclasses.asdict(eng.metrics)
    assert a.keys() == b.keys()
    assert set(sim.metrics.row()) == set(eng.metrics.row())
    inner_a = {k for v in sim.metrics.per_task.values() for k in v}
    inner_b = {k for v in eng.metrics.per_task.values() for k in v}
    assert inner_a == inner_b
    assert _tokens(reqs) == jax_tokens("colocated_6")


def test_backend_protocol_satisfied_by_engine_plane(seed_params):
    cluster, _ = _port("colocated_4", seed_params)
    ew = cluster.workers[0]
    assert isinstance(ew, Backend) and isinstance(ew, WorkerBase)
    snap = ew.snapshot(0.0, 0.5)
    assert snap.wid == ew.wid and snap.utilization == 0.5
    # no prefix cache configured: the Dispatcher sees no hit
    r = Request.from_prompt(0, _prompt(), max_new=2)
    assert ew.engine.prefix is None and ew.prefix_peek(r) == 0


def test_engine_worker_lifecycle_states(seed_params):
    cluster, reqs = _port("colocated_4", seed_params)
    assert all(r.state == RequestState.ARRIVED for r in reqs)
    cluster.run(reqs)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert _tokens(reqs) == jax_tokens("colocated_4")


def test_engine_backed_cluster_slot_plane_fallback(seed_params):
    cluster, reqs = _port("slot_plane", seed_params)
    assert not cluster.workers[0].engine.paged
    res = cluster.run(reqs)
    assert res.metrics.n_finished == res.metrics.n_total == 6
    assert all(len(r.generated) == r.l_out for r in reqs)
    assert _tokens(reqs) == jax_tokens("slot_plane")


def test_engine_cluster_rejects_impossible_workload_before_run(seed_params):
    """The full engine admission constraints (the paged fit-alone page
    bound included) are checked up front."""
    cluster = Cluster(ClusterConfig(
        model=SMOKE, backend="engine", n_workers=1, policy="hyperflexis",
        seed=0, engine=EngineConfig(n_slots=2, max_len=32, page_size=8,
                                    n_pages=2)),
        device="cpu", seed_params=seed_params)
    bad = [Request(rid=0, task="t", arrival=0.0, l_in=14, l_out=6,
                   ttft_slo=1.0, tpot_slo=1.0)]
    with pytest.raises(ValueError, match="pages"):
        cluster.run(bad)


# ---------------------------------------------------------------------------
# test_pd_engine.py
# ---------------------------------------------------------------------------

def test_engine_pd_cluster_end_to_end(seed_params):
    cluster, reqs = _port("pd_scaling", seed_params)
    assert [w.role for w in cluster.workers] == ["prefill", "decode"]
    assert all(isinstance(w, EngineWorker) for w in cluster.workers)
    assert cluster.workers[0].engine.park_on_prefill
    assert not cluster.workers[1].engine.park_on_prefill
    assert cluster.migrator is not None and cluster.scaler is not None

    res = cluster.run(reqs)
    m = res.metrics
    assert m.n_finished == m.n_total == len(reqs)
    assert res.kv_transfers >= 1
    assert cluster.tl.kv_bytes_moved > 0
    for r in reqs:
        assert r.state == RequestState.FINISHED
        assert len(r.generated) == r.l_out
        if r.l_out > 1:  # single-token requests finish at prefill
            assert r.decode_worker is not None
            assert r.decode_worker != r.prefill_worker
    assert _tokens(reqs) == jax_tokens("pd_scaling")


def test_engine_pd_fully_parked_prefill_engine_wakes_on_migration(
        seed_params):
    cluster, reqs = _port("pd_one_slot", seed_params)
    res = cluster.run(reqs)
    assert res.metrics.n_finished == res.metrics.n_total == len(reqs)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert _tokens(reqs) == jax_tokens("pd_one_slot")


def test_engine_pd_tokens_identical_to_collocated(seed_params):
    cluster, reqs_pd = _port("pd", seed_params)
    cluster.run(reqs_pd)
    cluster, reqs_col = _port("pd_colocated", seed_params)
    cluster.run(reqs_col)
    assert _tokens(reqs_pd) == _tokens(reqs_col)
    assert _tokens(reqs_pd) == jax_tokens("pd")
    assert _tokens(reqs_col) == jax_tokens("pd_colocated")


def test_engine_pd_runmetrics_schema_matches_sim_pd(seed_params):
    from repro_torch.serving.workload import poisson_workload

    cluster, reqs = _port("pd_6", seed_params)
    eng = cluster.run(reqs)
    sim = Cluster(ClusterConfig(
        model=get_config("qwen7b"), policy="hyperflexis", mode="pd",
        n_prefill=1, n_decode=1, seed=0)).run(
            poisson_workload(["gsm8k"], qps=16, n_per_task=5, seed=0))
    a = dataclasses.asdict(eng.metrics)
    b = dataclasses.asdict(sim.metrics)
    assert a.keys() == b.keys()
    assert set(eng.metrics.row()) == set(sim.metrics.row())
    assert _tokens(reqs) == jax_tokens("pd_6")


def test_engine_worker_role_flip_syncs_park_behavior(seed_params):
    cluster, _ = _port("pd", seed_params)
    w = cluster.workers[1]
    assert w.role == "decode" and not w.engine.park_on_prefill
    w.role = "prefill"
    assert w.engine.park_on_prefill
    w.role = "collocated"
    assert not w.engine.park_on_prefill

    slot_cluster = Cluster(ClusterConfig(
        model=SMOKE, backend="engine", n_workers=1, policy="hyperflexis",
        seed=0, engine=EngineConfig(n_slots=2, max_len=32,
                                    prefill_batch=1, paged=False)),
        device="cpu", seed_params=seed_params)
    with pytest.raises(ValueError, match="paged"):
        slot_cluster.workers[0].role = "prefill"


@pytest.mark.parametrize("kw", [dict(mode="pd"), dict(live_migration=True)],
                         ids=["pd", "live_migration"])
def test_engine_pd_and_live_migration_require_paged_plane(seed_params, kw):
    with pytest.raises(ValueError, match="paged"):
        Cluster(ClusterConfig(
            model=SMOKE, backend="engine", policy="hyperflexis", seed=0,
            engine=EngineConfig(n_slots=2, max_len=32, prefill_batch=1,
                                paged=False), **kw),
            device="cpu", seed_params=seed_params)


# ---------------------------------------------------------------------------
# test_fast_scaling.py
# ---------------------------------------------------------------------------

def _prompt(n=10):
    return (np.arange(1, n + 1, dtype=np.int32) * 3) % SMOKE.vocab_size


def _generate(model, max_new=5):
    eng = InferenceEngine(model, EngineConfig.smoke())
    r = Request.from_prompt(0, _prompt(), max_new=max_new)
    eng.submit(r)
    eng.run_until_done()
    return list(r.generated)


@pytest.fixture(scope="module")
def jax_generated():
    """The JAX engine's tokens for ``_prompt()`` on the same weights."""
    model = jax_build(jax_smoke("qwen7b"))
    eng = JEngine(model, model.init(jax.random.key(0)),
                  JEngineConfig.smoke(), fn_cache={})
    r = JRequest.from_prompt(0, _prompt(), max_new=5)
    eng.submit(r)
    eng.run_until_done()
    return list(r.generated)


def _engine_cluster(seed_params, **scaler_kw):
    from repro_torch.core.scaler import ScalerConfig

    scaler_kw.setdefault("weight_strategy", "d2d")
    return Cluster(ClusterConfig(
        model=SMOKE, n_workers=1, backend="engine",
        engine=EngineConfig.smoke(), scaling=True,
        scaler=ScalerConfig(max_workers=3, **scaler_kw),
    ), device="cpu", seed_params=seed_params)


def _force_actions(c, actions, now=1.0):
    """Drive the Cluster's commit path with canned scaler actions."""
    c.scaler.tick = lambda *a, **k: actions
    c._scaler_tick(now, c._by_wid)


def test_engine_replicas_own_their_weights(seed_params):
    """The initial replica's model holds the tensors its transport
    provisioned — storage of its own, disjoint from the seed and from
    the host offload — and the seed itself is not kept."""
    c = _engine_cluster(seed_params)
    w0 = c.workers[0]
    assert c.weights is not None and c.weights.owns(0)
    model = w0.engine.model
    owned = c.weights.params_of(0)
    assert _storages(model) == {t.untyped_storage().data_ptr()
                                for t in owned.values()}
    assert _disjoint(model, seed_params, c.weights.host)
    for name, t in model.state_dict().items():
        assert torch.equal(t, seed_params[name]), name
    assert model.device == torch.device("cpu")
    assert not any(isinstance(v, torch.nn.Module) and v is not model
                   for v in vars(c).values())


def test_engine_scale_out_d2d_and_scale_in_release(seed_params,
                                                   jax_generated):
    c = _engine_cluster(seed_params)
    _force_actions(c, [ScaleAction("out", "any", 0.2, strategy="d2d",
                                   warm=True)])
    assert len(c.workers) == 2
    new = c.workers[1]
    assert c.weights.owns(new.wid)
    assert _disjoint(c.workers[0].engine.model, new.engine.model)
    ev = [e for _, wid, e in c.timeline if wid == new.wid]
    assert any(e.startswith("scale_out:d2d") for e in ev)
    assert c._provision_s is not None and c._provision_s > 0

    ref = _generate(c.workers[0].engine.model)
    got = _generate(new.engine.model)
    assert got == ref == jax_generated

    new.activate(1.5, "collocated")
    _force_actions(c, [ScaleAction("in", "any", 0.0,
                                   worker_id=new.wid)], now=2.0)
    assert not c.weights.owns(new.wid)
    assert new.engine.model is None
    assert c._pick_donor() == 0  # only the seed replica donates now


def test_engine_scale_from_zero_falls_back_to_disk(seed_params,
                                                   jax_generated):
    c = _engine_cluster(seed_params)
    w0 = c.workers[0]
    w0.deactivate(0.0)
    c.weights.release(0)
    w0.engine.release_weights()
    assert c._pick_donor() is None
    _force_actions(c, [ScaleAction("out", "any", 0.2, strategy="d2d",
                                   warm=True)])
    new = c.workers[1]
    assert c.weights.owns(new.wid)
    ev = [e for _, wid, e in c.timeline if wid == new.wid]
    assert any(e.startswith("scale_out:disk") for e in ev)
    assert _generate(new.engine.model) == jax_generated


def test_release_weights_refuses_undrained_engine(seed_params):
    c = _engine_cluster(seed_params)
    eng = InferenceEngine(c.workers[0].engine.model, EngineConfig.smoke())
    eng.submit(Request.from_prompt(0, _prompt(), max_new=3))
    with pytest.raises(RuntimeError):
        eng.release_weights()
    eng.run_until_done()
    eng.release_weights()
    assert eng.model is None


def test_pick_donor_prefers_least_loaded(seed_params):
    c = _engine_cluster(seed_params)
    _force_actions(c, [ScaleAction("out", "any", 0.1, strategy="cpu",
                                   warm=True)])
    new = c.workers[1]
    new.activate(1.5, "collocated")
    c.workers[0].engine.queue.append(
        Request.from_prompt(9, _prompt(), max_new=2))
    assert c._pick_donor() == new.wid
    assert _disjoint(c.workers[0].engine.model, new.engine.model)


def test_provision_all_strategies_copy_without_aliasing(seed_params,
                                                        jax_generated):
    """Every Table-2 transport materializes tensors of the replica's
    own, equal to the source bit for bit, that decode the JAX engine's
    tokens; each provision feeds the TLManager's measured bandwidth."""
    tl = TLManager()
    wm = WeightManager(seed_params, tl=tl)
    donor = {k: v.clone() for k, v in seed_params.items()}
    wm.adopt(0, donor)
    got_all = [donor, wm.host]
    for wid, strategy in enumerate(STRATEGIES, start=1):
        got, dt = wm.provision(
            wid, strategy, donor=0 if strategy == "d2d" else None)
        assert dt > 0.0 and wm.owns(wid)
        for name, t in got.items():
            assert torch.equal(t, seed_params[name]), (strategy, name)
        got_all.append(got)
        assert _generate(replica_model(SMOKE, got)) == jax_generated, \
            strategy
        bw = tl.measured_weight_bw(strategy)
        assert bw is not None and bw > 0
        t = tl.weight_load_time(SMOKE, strategy, nbytes=wm.nbytes,
                                record=False)
        assert t == pytest.approx(wm.nbytes / bw)
    assert _disjoint(seed_params, *got_all)
    assert tl.n_weight_loads == len(STRATEGIES)


def test_weight_manager_ownership_and_refusals(seed_params):
    wm = WeightManager(seed_params)
    assert not wm.owns(0) and wm.donors() == []
    with pytest.raises(ValueError):
        wm.provision(1, "d2d")  # no live donor: scale-from-zero
    wm.adopt(0, seed_params)
    with pytest.raises(ValueError):
        wm.adopt(0, seed_params)
    wm.provision(1, "d2d", donor=0)
    wm.release(0)
    with pytest.raises(ValueError):
        wm.provision(2, "d2d", donor=0)  # donor scaled in since
    with pytest.raises(ValueError):
        wm.provision(1, "cpu")  # wid already owns weights
    with pytest.raises(ValueError):
        wm.provision(3, "nvlink")  # unknown strategy
    assert checkpoint_nbytes(wm.ckpt_dir, 0) == wm.nbytes


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_warm_decode_blocks_leaves_an_idle_engine_as_it_was(
        seed_params, jax_generated, paged):
    """The warm-up's all-frozen decode blocks write nothing a later
    request could see, refuse an engine that holds work, and the engine
    then decodes the JAX engine's tokens."""
    model = replica_model(SMOKE, seed_params)
    eng = InferenceEngine(model, EngineConfig.smoke(paged=paged,
                                                    decode_block=8))
    before = [{k: t.clone() for k, t in seg.items()} for seg in eng.caches]
    eng.warm_decode_blocks()
    for seg, old in zip(eng.caches, before):
        for k, t in seg.items():
            assert torch.equal(t, old[k]), k
    r = Request.from_prompt(0, _prompt(), max_new=5)
    eng.submit(r)
    with pytest.raises(RuntimeError, match="idle"):
        eng.warm_decode_blocks()
    eng.run_until_done()
    assert list(r.generated) == jax_generated


# ---------------------------------------------------------------------------
# test_live_migration.py
# ---------------------------------------------------------------------------

def _drive(c, reqs, on_event=None, max_events=200_000):
    s = ServingSession(c, admission="none")
    for r in reqs:
        s.submit_request(r)
    for _ in range(max_events):
        kind = c.process_next()
        if kind is None:
            break
        if on_event is not None:
            on_event(kind)
        if (all(r.state == RequestState.FINISHED for r in reqs)
                and not c._evac):
            break
    return s.close(requests=list(reqs))


def test_engine_cluster_evacuation_token_identity(seed_params):
    """Migrate-then-scale-in on the engine plane: evacuating a
    collocated engine mid-run moves live paged KV, and the evacuated
    streams stay identical to an undisturbed run — and to JAX's."""
    cluster, base = _port("evac_base", seed_params)
    cluster.run(base)
    want = _tokens(base)
    assert all(len(g) == 16 for g in want)
    assert want == jax_tokens("evac_base")

    c, reqs = _port("evac_base", seed_params, live_migration=True)
    c._materialize_prompts(reqs)
    kicked = []

    def on_event(kind):
        w0 = c._by_wid[0]
        if not kicked and any(r.tokens_done >= 1 for r in w0.running):
            c._begin_evacuation(
                w0, ScaleAction("in", "collocated", 0.0, worker_id=0),
                c.now,
            )
            kicked.append(True)

    res = _drive(c, reqs, on_event)
    assert kicked, "worker 0 never had a decoding resident"
    assert res.metrics.n_finished == len(reqs)
    assert res.n_live_migrations >= 1
    assert not c._by_wid[0].active
    assert _tokens(reqs) == want
    moved = [r for r in reqs if r.n_migrations > 0]
    assert moved and all(r.decode_worker == 1 for r in moved)


# ---------------------------------------------------------------------------
# Checkpoints (distributed/checkpoint.py in torch)
# ---------------------------------------------------------------------------

def _tree(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"embed": torch.randn(16, 8, generator=g).to(dtype),
            "layers.0.attn.wq": torch.randn(8, 8, generator=g).to(dtype),
            "final_norm": torch.randn(8, generator=g).to(dtype)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_checkpoint_round_trip_bit_exact(tmp_path, dtype):
    tree = _tree(dtype)
    save_checkpoint(str(tmp_path), 3, tree, extra={"note": "x"})
    got, extra = load_checkpoint(str(tmp_path), 3, tree, device="cpu")
    assert extra == {"note": "x"} and list(got) == list(tree)
    for k, t in tree.items():
        assert got[k].dtype == dtype
        assert torch.equal(_bits(got[k]), _bits(t)), k
        assert got[k].untyped_storage().data_ptr() != \
            t.untyped_storage().data_ptr()
    step, again, _ = load_latest(str(tmp_path), tree, device="cpu")
    assert step == 3 and all(torch.equal(_bits(again[k]), _bits(tree[k]))
                             for k in tree)


def test_checkpoint_refuses_a_mismatched_load(tmp_path):
    tree = _tree(torch.float32)
    save_checkpoint(str(tmp_path), 0, tree)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), 0,
                        {**tree, "final_norm": torch.zeros(9)}, device="cpu")
    bf16 = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        load_checkpoint(str(tmp_path), 0, {**tree, "final_norm": bf16},
                        device="cpu")
    with pytest.raises(KeyError):
        load_checkpoint(str(tmp_path), 0, {**tree, "head": torch.zeros(2)},
                        device="cpu")
    # the manifest must agree with what is stored
    path = tmp_path / "step_00000000" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["arrays"]["embed"]["shape"] = [8, 16]
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="manifest"):
        load_checkpoint(str(tmp_path), 0, tree, device="cpu")


def test_checkpoint_sweeps_tmp_leftovers(tmp_path):
    tree = _tree(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, tree)
    stale = tmp_path / ".tmp_dead_writer"
    stale.mkdir()
    (stale / "arrays.pt").write_bytes(b"half")
    assert all_steps(str(tmp_path)) == [1]
    step, _, _ = load_latest(str(tmp_path), tree, device="cpu")
    assert step == 1
    assert not any(n.startswith(".tmp_") for n in os.listdir(tmp_path))
    assert load_latest(str(tmp_path / "empty"), tree) is None


def test_checkpoint_keep_last(tmp_path):
    tree = _tree(torch.float32)
    for step in range(5):
        save_checkpoint(str(tmp_path), step, tree, keep_last=2)
    assert sorted(all_steps(str(tmp_path))) == [3, 4]
    assert latest_step(str(tmp_path)) == 4


def test_checkpoint_nbytes_is_the_tensors_bytes(tmp_path):
    tree = {**_tree(torch.bfloat16), "f32": torch.zeros(3, 5),
            # a view of a larger tensor is stored as its own bytes
            "view": torch.arange(64, dtype=torch.float32)[8:24]}
    save_checkpoint(str(tmp_path), 0, tree)
    want = sum(t.numel() * t.element_size() for t in tree.values())
    assert checkpoint_nbytes(str(tmp_path), 0) == want
    got, _ = load_checkpoint(str(tmp_path), 0, tree, device="cpu")
    assert torch.equal(got["view"], tree["view"])


# ---------------------------------------------------------------------------
# The device rule
# ---------------------------------------------------------------------------

def test_engine_plane_needs_a_card_unless_given_the_cpu(monkeypatch,
                                                        seed_params):
    from repro_torch.serving.workload import poisson_workload

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ClusterConfig(model=SMOKE, backend="engine", n_workers=1,
                        engine=EngineConfig.smoke(), seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Cluster(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Cluster(cfg, device="cuda", seed_params=seed_params)
    c = Cluster(cfg, device="cpu")
    assert c.device == torch.device("cpu")
    assert c.workers[0].engine.model.device == torch.device("cpu")
    # the sim plane touches no device at all
    sim = Cluster(ClusterConfig(model=get_config("qwen7b"), n_workers=1,
                                seed=0))
    res = sim.run(poisson_workload(["gsm8k"], qps=8, n_per_task=4, seed=0))
    assert res.metrics.n_finished == res.metrics.n_total == 4
