"""The port's control plane against the JAX package's, on the sim plane.

The port keeps line-for-line copies of the JAX-free control plane
(Dispatcher and policies, Scaler, Migrator, TLManager, SLO mapper,
faults, recovery, ServingSession, SimWorker, workloads, metrics) and of
the sim plane of ``Cluster``.  Each case builds the same configuration
in both packages, generates its workload with each package's own
generator from one seed, and runs it: the metrics, the timeline, the
result's counters and every request's stamps must be **equal**, not
close.  A mismatch means a copy drifted.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core.request import FOUR_TASK_SET as FOUR  # noqa: E402


def _pkg(name: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        get_config=mod("configs").get_config,
        Cluster=mod("serving.cluster").Cluster,
        ClusterConfig=mod("serving.cluster").ClusterConfig,
        ScalerConfig=mod("core.scaler").ScalerConfig,
        FaultInjector=mod("core.faults").FaultInjector,
        PrioritySLOMapper=mod("core.slo_mapper").PrioritySLOMapper,
        bands_from_tasks=mod("core.slo_mapper").bands_from_tasks,
        TASKS=mod("core.request").TASKS,
        Request=mod("core.request").Request,
        workload=mod("serving.workload"),
    )


def _poisson(m, qps=10.0, n=24, seed=0, tasks=FOUR):
    return m.workload.poisson_workload(list(tasks), qps=qps, n_per_task=n,
                                       seed=seed)


def _case(model="qwen7b", workload=_poisson, **kw):
    """A case: (package namespace) -> (ClusterConfig, requests);
    ``kw`` values that are callables are built per package."""
    def build(m):
        cfg_kw = {k: (v(m) if callable(v) else v) for k, v in kw.items()}
        cfg_kw.setdefault("n_workers", 2)
        cfg_kw.setdefault("policy", "hyperflexis")
        cfg = m.ClusterConfig(model=m.get_config(model), seed=0, **cfg_kw)
        return cfg, workload(m)
    return build


def _scaler(**kw):
    return lambda m: m.ScalerConfig(**kw)


def _faults(spec, seed=0):
    return lambda m: m.FaultInjector.from_spec(spec, seed=seed)


def _mapper(m):
    return m.PrioritySLOMapper(m.bands_from_tasks([m.TASKS[t] for t in FOUR]))


def _ramp(m):
    return m.workload.ramp_workload(list(FOUR), qps_per_class=3.0,
                                    join_every=4.0, duration=16.0, seed=5)


def _burst(m, n=48, seed=1):
    """Tight-TPOT streams arriving inside 1.2 s, which the live-migration
    coordinator rescues onto scaled-out replicas."""
    rng = np.random.default_rng(seed)
    reqs = [m.Request(rid=i, task="interactive",
                      arrival=float(rng.uniform(0.0, 1.2)),
                      l_in=int(rng.integers(250, 450)), l_out=120,
                      ttft_slo=8.0, tpot_slo=0.06) for i in range(n)]
    return sorted(reqs, key=lambda r: r.arrival)


def _shared_prefix(m):
    return m.workload.shared_prefix_workload(n=48, qps=12.0, seed=1)


CASES = {
    **{f"colocated_{p}": _case(policy=p)
       for p in ("hyperflexis", "rr", "scorpio", "aladdin", "sa")},
    "pd": _case(mode="pd", n_prefill=1, n_decode=1),
    "pd_one_shot_rr": _case(mode="pd", n_prefill=1, n_decode=1,
                            one_shot_pd=True, policy="rr"),
    "scaling_d2d": _case(workload=lambda m: _poisson(m, qps=24.0, n=30),
                         n_workers=1, scaling=True,
                         scaler=_scaler(max_workers=4,
                                        weight_strategy="d2d")),
    "scaling_auto": _case(workload=lambda m: _poisson(m, qps=24.0, n=30),
                          n_workers=1, scaling=True,
                          scaler=_scaler(max_workers=4,
                                         weight_strategy="auto")),
    "pd_scaling": _case(workload=lambda m: _poisson(m, qps=20.0, n=24),
                        mode="pd", n_prefill=1, n_decode=1, scaling=True,
                        scaler=_scaler(max_workers=4)),
    "live_migration": _case(workload=lambda m: _poisson(m, qps=16.0),
                            mode="pd", n_prefill=1, n_decode=2,
                            live_migration=True),
    "live_migration_scaling": _case(
        workload=_burst, n_workers=1, policy="rr", live_migration=True,
        scaling=True, scaler=_scaler(tau=0.25, max_workers=3,
                                     weight_strategy="d2d")),
    "crash_recovery": _case(n_workers=3,
                            faults=_faults("crash:wid=1,t=1.5")),
    "crash_no_recovery": _case(n_workers=3, recovery=False,
                               faults=_faults("crash:wid=1,t=1.5")),
    "faults_mixed": _case(
        mode="pd", n_prefill=1, n_decode=2, scaling=True,
        scaler=_scaler(max_workers=4),
        faults=_faults("kv_drop:p=0.2;weight_fail:strategy=*,p=0.5;"
                       "straggler:wid=0,slowdown=2.0,t=0.5,until=3.0",
                       seed=3)),
    "chunked_256": _case(chunk_tokens=256),
    "prefix_cache": _case(workload=_shared_prefix, prefix_cache=True),
    "spec_decode": _case(spec_decode=True),
    "slo_mapper_ramp": _case(workload=_ramp, slo_mapper=_mapper),
    "mamba2": _case(model="mamba2-2.7b"),
    "mamba2_pd_scaling": _case(model="mamba2-2.7b", mode="pd",
                               workload=lambda m: _poisson(m, qps=20.0),
                               n_prefill=1, n_decode=1, scaling=True,
                               scaler=_scaler(max_workers=3)),
}

_COUNTERS = [f.name for f in dataclasses.fields(
    importlib.import_module("repro_torch.serving.cluster").ClusterResult)
    if f.name not in ("metrics", "requests", "timeline", "monitor")]


def _run(pkg: str, case):
    m = _pkg(pkg)
    cfg, reqs = case(m)
    res = m.Cluster(cfg).run(reqs)
    return {
        "metrics": dataclasses.asdict(res.metrics),
        "row": res.metrics.row(),
        "timeline": list(res.timeline),
        "counters": {k: getattr(res, k) for k in _COUNTERS},
        "requests": [(r.rid, r.task, r.arrival, r.l_in, r.l_out,
                      r.ttft_slo, r.tpot_slo, r.state.name,
                      r.first_token_time, r.finish_time, r.tokens_done,
                      r.prefill_worker, r.decode_worker, r.n_migrations)
                     for r in res.requests],
    }


@pytest.mark.parametrize("name", sorted(CASES))
def test_sim_plane_equal_to_jax(name):
    want = _run("repro", CASES[name])
    got = _run("repro_torch", CASES[name])
    assert want["metrics"]["n_total"] > 0
    for key in ("metrics", "row", "timeline", "counters", "requests"):
        assert got[key] == want[key], key


def test_counter_fields_match_jax():
    """The port's ClusterResult carries the JAX package's fields."""
    jax_res = importlib.import_module("repro.serving.cluster").ClusterResult
    torch_res = importlib.import_module(
        "repro_torch.serving.cluster").ClusterResult
    assert ([f.name for f in dataclasses.fields(torch_res)]
            == [f.name for f in dataclasses.fields(jax_res)])


def test_cases_exercise_what_they_name():
    """Each feature case really moved the counter it is about, so an
    equal result is not two runs where nothing happened."""
    runs = {n: _run("repro_torch", CASES[n])["counters"]
            for n in ("scaling_d2d", "pd", "live_migration_scaling",
                      "crash_recovery", "spec_decode", "prefix_cache")}
    assert runs["scaling_d2d"]["n_scale_out"] > 0
    assert runs["pd"]["kv_transfers"] > 0
    assert runs["live_migration_scaling"]["n_live_migrations"] > 0
    assert runs["crash_recovery"]["n_faults"] > 0
    assert runs["crash_recovery"]["n_recovered"] > 0
    assert runs["spec_decode"]["spec_dispatches"] > 0
    assert runs["prefix_cache"]["prefix_stats"]
