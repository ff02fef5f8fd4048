"""Engine-plane fault recovery of the port's ``Cluster`` against the JAX
package's (ports of the engine cases of ``tests/test_fault_recovery.py``):
the weight-provisioning fallback chain under an injected d2d failure and
a dead donor, the donor guards, replica-crash recovery with the tokens
of a fault-free run, recovery off shedding, the last weight owner's
crash scaling out from disk, and a completion inside an in-flight step
re-homed at the crash.

Both clusters serve the smoke qwen7b with the JAX package's weights for
the run's seed (the port's through ``convert.params_from_jax``), in f32
on the CPU, and every request that finishes generates the JAX
``Cluster``'s tokens on the same configuration and workload.  What the
cases assert does not hang on measured step times, so it holds on a
host of any speed or load (the cluster's clock is built from them):

- a recovered stream re-emits the tokens of the fault-free run
  whatever step the crash interrupts (greedy decode, the generated
  tokens folded into the prompt);
- a straggler fault stretches the crashing replica's steps 1000-fold
  (at least 0.1 s of cluster time for any measured step), so its crash
  at 10 ms lands inside its first step, with its requests in flight —
  the JAX test's schedules put the crash there only on a slow enough
  host;
- a stranded handle would end the run at the drain horizon, so the
  stranding case sets a horizon of 600 s (the JAX test's 5 s, against
  seconds of measured steps on a loaded host, would not tell the two
  apart) and asserts the run ended well before it.
"""

import functools
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.faults import FaultInjector  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cluster import Cluster, ClusterConfig  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402

SMOKE = get_smoke_config("qwen7b")


@functools.lru_cache(maxsize=None)
def seed_params(seed: int) -> dict:
    """The JAX package's smoke qwen7b weights for ``seed`` — what its
    engine-plane Cluster draws — in the port's names."""
    tree = jax_build(jax_smoke("qwen7b")).init(jax.random.key(seed))
    return params_from_jax(jax.tree.map(np.asarray, tree), SMOKE)


def _pkg(name: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        smoke=mod("configs").get_smoke_config("qwen7b"),
        Cluster=mod("serving.cluster").Cluster,
        ClusterConfig=mod("serving.cluster").ClusterConfig,
        EngineConfig=mod("serving.engine").EngineConfig,
        ScalerConfig=mod("core.scaler").ScalerConfig,
        FaultInjector=mod("core.faults").FaultInjector,
        engine_smoke_workload=mod("serving.workload").engine_smoke_workload,
    )


def _cluster(m, cfg, seed: int):
    """``m``'s Cluster on ``cfg``: the port's on the CPU over JAX's
    weights for ``seed``."""
    if m.Cluster is Cluster:
        return Cluster(cfg, device="cpu", seed_params=seed_params(seed))
    return m.Cluster(cfg)


def _tokens(reqs, finished_only=False) -> dict:
    """rid -> generated tokens (of the finished requests only, if
    asked; either package's requests)."""
    return {r.rid: list(r.generated) for r in reqs
            if not finished_only or r.state.name == "FINISHED"}


def _agree(reqs, jreqs) -> None:
    """Every request that finished in both clusters generated the same
    tokens, and some did."""
    got = _tokens(reqs, finished_only=True)
    want = _tokens(jreqs, finished_only=True)
    both = set(got) & set(want)
    assert both and all(got[rid] == want[rid] for rid in both)


# ---------------------------------------------------------------------------
# Weight-provisioning faults + donor guards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_cluster():
    cfg = ClusterConfig(
        model=SMOKE, backend="engine", n_workers=2,
        policy="hyperflexis", seed=0,
        engine=EngineConfig(n_slots=4, max_len=48, prefill_batch=2,
                            page_size=8, chunk_size=16),
        faults=FaultInjector(weight_fail_p={"d2d": 1.0}, seed=0),
    )
    return Cluster(cfg, device="cpu", seed_params=seed_params(0))


def _same_weights(cl, wid: int) -> None:
    """Replica ``wid`` holds the seed weights, bit for bit."""
    got = cl.weights.params_of(wid)
    for name, t in seed_params(0).items():
        assert torch.equal(got[name], t), name


def test_weight_fail_falls_back_down_the_chain(engine_cluster):
    cl = engine_cluster
    w = cl._make_worker(90, "collocated", active=False,
                        strategy="d2d", donor=0)
    # injected d2d failure -> the cpu offload serves the copy
    assert cl._provision_strategy == "cpu"
    assert cl.weights.owns(90)
    assert any("weight_fail:d2d" in str(ev)
               for _, wid, ev in cl.timeline if wid == 90)
    _same_weights(cl, 90)
    cl.weights.release(90)
    w.engine.release_weights()
    assert not cl.weights.owns(90) and w.engine.model is None


def test_dead_donor_mid_pull_falls_back(engine_cluster):
    """A donor that owns no weights makes the d2d pull itself raise
    (the fault injector is off here): the chain falls through to the
    host copy or the disk."""
    cl = engine_cluster
    saved = cl.faults
    cl.faults = None
    try:
        cl._make_worker(91, "collocated", active=False,
                        strategy="d2d", donor=777)  # bogus donor
        assert cl._provision_strategy in ("cpu", "disk")
        assert cl.weights.owns(91)
        _same_weights(cl, 91)
    finally:
        cl.faults = saved
        cl.weights.release(91)


def test_pick_donor_skips_evacuating_and_crashed(engine_cluster):
    cl = engine_cluster
    w0, w1 = cl.workers[0], cl.workers[1]
    assert cl._pick_donor() in (w0.wid, w1.wid)
    w0.evacuating = True
    assert cl._pick_donor() == w1.wid
    w1.crashed = True
    assert cl._pick_donor() is None
    w0.evacuating = w1.crashed = False


# ---------------------------------------------------------------------------
# Engine plane end to end: crash recovery is token-exact
# ---------------------------------------------------------------------------

# a crash on replica 1 inside its first step (see the module docstring)
CRASH_W1 = "straggler:wid=1,slowdown=1e3;crash:wid=1,t=0.01"


def _engine_run(pkg: str, spec, recovery=True, n=14, seed=5):
    m = _pkg(pkg)
    reqs = m.engine_smoke_workload(n=n, qps=2000.0, seed=seed, clip_out=20)
    faults = m.FaultInjector.from_spec(spec, seed=seed) if spec else None
    cfg = m.ClusterConfig(model=m.smoke, backend="engine", n_workers=2,
                          policy="hyperflexis", seed=seed, faults=faults,
                          recovery=recovery, monitor_interval=0.005)
    res = _cluster(m, cfg, seed).run(reqs)
    return res, reqs


@functools.lru_cache(maxsize=None)
def jax_tokens(spec, recovery=True) -> dict:
    """Every request's tokens from the JAX Cluster's ``_engine_run``."""
    _, reqs = _engine_run("repro", spec, recovery)
    return _tokens(reqs)


def test_engine_crash_recovery_token_identical():
    base, base_reqs = _engine_run("repro_torch", None)
    assert base.metrics.n_finished == 14
    res, reqs = _engine_run("repro_torch", CRASH_W1)
    assert res.metrics.n_finished + res.metrics.n_failed == 14
    assert res.n_recovered > 0 and res.n_lost == 0
    # greedy decode + prompt folding: recovered streams re-emit the
    # exact tokens of the fault-free run — and of the JAX Cluster's
    assert _tokens(reqs) == _tokens(base_reqs) == jax_tokens(None)
    assert jax_tokens(CRASH_W1) == jax_tokens(None)


def test_engine_crash_recovery_off_sheds():
    res, reqs = _engine_run("repro_torch", CRASH_W1, recovery=False)
    assert res.metrics.n_failed > 0
    assert res.metrics.n_finished + res.metrics.n_failed == 14
    done = _tokens(reqs, finished_only=True)
    assert done and all(toks == jax_tokens(None)[rid]
                        for rid, toks in done.items())


def test_engine_last_weight_owner_crash_scales_from_disk():
    def run(pkg):
        m = _pkg(pkg)
        reqs = m.engine_smoke_workload(n=8, qps=2000.0, seed=4, clip_out=8)
        faults = m.FaultInjector.from_spec(
            "straggler:wid=0,slowdown=1e3;crash:wid=0,t=0.01", seed=4)
        cfg = m.ClusterConfig(
            model=m.smoke, backend="engine", n_workers=1,
            policy="hyperflexis", seed=4, faults=faults,
            monitor_interval=0.005, scaling=True,
            scaler=m.ScalerConfig(tau=0.02, max_workers=2,
                                  weight_strategy="d2d"),
            engine=m.EngineConfig(n_slots=4, max_len=48, prefill_batch=2,
                                  page_size=8, chunk_size=16),
        )
        return _cluster(m, cfg, 4).run(reqs), reqs

    res, reqs = run("repro_torch")
    # the only weight owner died: the first scale-out must come from
    # disk (later ones may d2d off the freshly provisioned replica)
    outs = [ev for _, _, ev in res.timeline if ev.startswith("scale_out:")]
    assert outs and "disk" in outs[0]
    assert res.metrics.n_finished + res.metrics.n_failed == 8
    assert res.metrics.n_finished > 0
    _agree(reqs, run("repro")[1])


HORIZON = 600.0


def test_engine_crash_mid_step_completion_not_stranded():
    """A request can complete (and leave every engine pool) while its
    step is still in flight in cluster time; a crash in that window
    must re-home it, not strand its handle until the drain horizon
    (600 s here: the run, seconds of measured steps, must end long
    before it).  The straggler stretches w1's step durations so the
    crash precedes its first step_done whatever the host's speed;
    l_out=1 completes each request inside its own prefill step."""
    def run(pkg):
        m = _pkg(pkg)
        reqs = m.engine_smoke_workload(n=8, qps=2000.0, seed=6, clip_out=1)
        faults = m.FaultInjector.from_spec(
            "straggler:wid=1,slowdown=1e6;crash:wid=1,t=0.05", seed=6)
        cfg = m.ClusterConfig(model=m.smoke, backend="engine", n_workers=2,
                              policy="hyperflexis", seed=6, faults=faults,
                              monitor_interval=0.005,
                              drain_timeout=HORIZON)
        return _cluster(m, cfg, 6).run(reqs), reqs

    res, reqs = run("repro_torch")
    assert res.metrics.n_finished + res.metrics.n_failed == 8
    assert res.n_recovered > 0
    # no orphaned handle rode the drain horizon
    assert res.metrics.makespan < HORIZON / 2
    _agree(reqs, run("repro")[1])
