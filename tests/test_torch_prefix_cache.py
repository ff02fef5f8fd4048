"""The prefix cache on the port's paged plane, against the JAX package.

A seeded fuzz of ``PagedKVManager`` + ``PrefixCache`` operations run on
JAX's and on the port's managers side by side, with tables, pages held,
free lists and cache stats equal after every operation; the device
table re-uploaded after ``lookup_prefix`` and ``truncate``; then the
engine cases of ``tests/test_prefix_cache.py`` on the same weights as
the JAX engine — token identity with the cache on and off across page
and chunk sizes, ``n_prefill_tokens`` and ``prefix.stats()`` equal to
JAX's, a request re-hitting its own published pages (also after a
recompute preemption) — and the check that no prefill, decode or verify
write ever lands in a cache-owned page; last, the engine-plane
``Cluster`` cases (P/D with the cache, the metrics schema, a full hit
admitted where a cold prompt is not), with every request's tokens and
the replicas' ``prefix_stats`` equal to the JAX ``Cluster``'s.

f32 on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.kv_manager import PagedKVManager as JPagedKVManager  # noqa
from repro.serving.prefix_cache import PrefixCache as JPrefixCache  # noqa
from repro.serving.workload import (  # noqa: E402
    materialize_prompts as jmaterialize,
    shared_prefix_workload as jshared_prefix_workload,
)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cluster import Cluster, ClusterConfig  # noqa: E402
from repro_torch.serving.engine import EngineConfig, InferenceEngine  # noqa
from repro_torch.serving.kv_manager import PagedKVManager  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.workload import (  # noqa: E402
    materialize_prompts,
    shared_prefix_workload,
)

SMOKE = get_smoke_config("qwen7b")
JMODEL = jax_build(jax_smoke("qwen7b"))
JPARAMS = JMODEL.init(jax.random.key(0))
SEED_PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), SMOKE)
MODEL = Model(SMOKE, device="cpu")
MODEL.load_state_dict(SEED_PARAMS)
_FN_CACHE: dict = {}   # jitted JAX steps shared by every JAX engine below


# ---------------------------------------------------------------------------
# The manager and the cache, operation for operation against JAX's
# ---------------------------------------------------------------------------

def _managers(n_slots, max_len, ps, n_pages):
    out = []
    for kv, pc in ((PagedKVManager(n_slots, max_len, ps, n_pages,
                                   device="cpu"), PrefixCache),
                   (JPagedKVManager(n_slots, max_len, ps, n_pages),
                    JPrefixCache)):
        kv.attach_prefix_cache(pc(kv.alloc, ps))
        out.append(kv)
    return out


def _state(kv) -> tuple:
    return (kv.table.tolist(), [kv.n_pages_held(s)
                                for s in range(kv.n_slots)],
            list(kv.alloc._free), kv.n_free_pages, kv.n_available_pages,
            kv.prefix.stats(), sorted(
                (p, kv.prefix.refs(p)) for p in kv.prefix._entries))


def test_manager_and_cache_fuzz_match_jax():
    """~200 seeded operations — ensure, lookup_prefix on a fresh slot,
    publish_prefix, release, truncate, evict — on a scarce pool (so
    ensure evicts cached pages), both packages in lockstep: every
    return value and the whole state equal after every operation."""
    n_slots, max_len, ps = 4, 32, 4
    rng = np.random.default_rng(0)
    ours, theirs = _managers(n_slots, max_len, ps, n_pages=14)
    prompts = {}
    kinds = ["ensure", "lookup", "publish", "release", "truncate", "evict"]
    n_ops = 0
    for _ in range(200):
        kind = kinds[rng.integers(len(kinds))]
        s = int(rng.integers(n_slots))
        if kind == "lookup":
            if ours.n_pages_held(s):
                continue
            g, n = int(rng.integers(3)), int(rng.integers(1, max_len))
            prompts[s] = (1000 * g + np.arange(n)).astype(np.int32)
            calls = ("lookup_prefix", s, prompts[s])
        elif kind == "ensure":
            calls = ("ensure", s, int(rng.integers(1, max_len + 1)))
        elif kind == "publish":
            if s not in prompts:
                continue
            calls = ("publish_prefix", s, prompts[s])
        elif kind == "release":
            prompts.pop(s, None)
            calls = ("release", s)
        elif kind == "truncate":
            held = ours.n_pages_held(s) * ps
            calls = ("truncate", s, int(rng.integers(0, held + 1)))
        else:
            n = int(rng.integers(1, 4))
            got = ours.prefix.evict(n)
            assert got == theirs.prefix.evict(n)
            assert _state(ours) == _state(theirs)
            n_ops += 1
            continue
        name, *args = calls
        got = getattr(ours, name)(*args)
        want = getattr(theirs, name)(*args)
        assert got == want, (name, args)
        assert _state(ours) == _state(theirs), (name, args)
        n_ops += 1
    assert n_ops > 150
    stats = ours.prefix.stats()
    assert stats["n_hit_tokens"] > 0 and stats["n_evicted"] > 0


def test_device_table_reuploaded_after_lookup_and_truncate():
    kv = PagedKVManager(2, 32, 4, device="cpu")
    kv.attach_prefix_cache(PrefixCache(kv.alloc, 4))
    toks = np.arange(17, dtype=np.int32)
    assert kv.ensure(0, 17)
    kv.publish_prefix(0, toks)
    t0 = kv.device_table()
    assert kv.device_table() is t0          # no change: same tensor
    assert kv.lookup_prefix(1, toks) == 16
    t1 = kv.device_table()
    assert t1 is not t0
    assert np.array_equal(t1.numpy(), kv.table)
    assert kv.truncate(0, 17) == 0          # no-op: same tensor
    assert kv.device_table() is t1
    assert kv.truncate(0, 8) == 3
    t2 = kv.device_table()
    assert t2 is not t1 and np.array_equal(t2.numpy(), kv.table)


def test_prefix_cache_must_share_the_allocator():
    kv = PagedKVManager(2, 32, 4, device="cpu")
    other = PagedKVManager(2, 32, 4, device="cpu")
    with pytest.raises(AssertionError, match="PageAllocator"):
        kv.attach_prefix_cache(PrefixCache(other.alloc, 4))


# ---------------------------------------------------------------------------
# Engine: token identity with the cache on and off, against JAX
# ---------------------------------------------------------------------------

def _shared_prompts(n, prefix_len, seed=42):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, SMOKE.vocab_size,
                          size=prefix_len).astype(np.int32)
    return [np.concatenate([
        prefix, rng.integers(0, SMOKE.vocab_size, size=2 + k)
        .astype(np.int32)]) for k in range(n)]


def _engines(**ekw):
    return (InferenceEngine(MODEL, EngineConfig(**ekw)),
            JEngine(JMODEL, JPARAMS, JEngineConfig(**ekw),
                    fn_cache=_FN_CACHE))


def _sequential(eng, make_req, prompts, max_new=4):
    """Each prompt runs to completion before the next is submitted, so
    every prefill publishes before the next one looks up."""
    reqs = []
    for i, p in enumerate(prompts):
        r = make_req(i, p.copy(), max_new=max_new)
        eng.submit(r)
        eng.run_until_done()
        reqs.append(r)
    return reqs


def _summary(eng, reqs) -> tuple:
    return ([list(r.generated) for r in reqs],
            [r.prefix_hit_tokens for r in reqs], eng.n_prefill_tokens,
            eng.prefix.stats() if eng.prefix is not None else None,
            eng.kv.n_free_pages, eng.kv.n_available_pages)


@pytest.mark.parametrize("ps,cs", [(8, 16), (4, 8), (8, 8), (4, 16)])
def test_engine_token_identity_cache_on_off(ps, cs):
    """Identical tokens with the cache on and off across page and chunk
    sizes, each equal to the JAX engine's, with the same hits, prefill
    tokens and cache stats — and the cached run skips exactly its hit
    tokens of prefill."""
    prompts = _shared_prompts(4, prefix_len=17)
    out = {}
    for on in (False, True):
        eng, jeng = _engines(n_slots=4, max_len=48, prefill_batch=2,
                             page_size=ps, chunk_size=cs, prefix_cache=on)
        got = _summary(eng, _sequential(eng, Request.from_prompt, prompts))
        want = _summary(jeng, _sequential(jeng, JRequest.from_prompt,
                                          prompts))
        assert got == want
        out[on] = got
    assert out[True][0] == out[False][0]
    hits = out[True][3]["n_hit_tokens"]
    assert hits > 0 and sum(out[True][1]) == hits
    assert out[False][2] - out[True][2] == hits


def test_engine_preempted_request_rehits_own_pages():
    """A second identical prompt hits the first one's published pages;
    and under a pool too small for two, the recompute-preempted request
    re-admits over the pages its own prefill published — tokens, hits
    and stats equal to the JAX engine's, and to a roomy pool's."""
    p = np.arange(1, 18, dtype=np.int32)
    eng, jeng = _engines(n_slots=2, max_len=32, prefill_batch=1,
                         page_size=4, chunk_size=8, prefix_cache=True)
    got = _summary(eng, _sequential(eng, Request.from_prompt, [p, p],
                                    max_new=3))
    want = _summary(jeng, _sequential(jeng, JRequest.from_prompt, [p, p],
                                      max_new=3))
    assert got == want
    assert got[1] == [0, 16] and got[0][0] == got[0][1]

    prompts = [np.arange(1, 13, dtype=np.int32),
               np.arange(41, 50, dtype=np.int32)]
    kw = dict(n_slots=2, max_len=24, prefill_batch=2, page_size=4,
              chunk_size=8, prefix_cache=True)
    out = []
    for eng, make in zip(_engines(n_pages=8, **kw),
                         (Request.from_prompt, JRequest.from_prompt)):
        reqs = [make(i, q.copy(), max_new=10) for i, q in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.state == type(r.state).FINISHED for r in reqs)
        out.append(_summary(eng, reqs))
    assert out[0] == out[1]
    stats = out[0][3]
    # one lookup per admission: more than two means a re-admission
    # after a preemption, and it hit
    assert stats["n_lookups"] > 2 and stats["n_hit_tokens"] > 0
    roomy = InferenceEngine(MODEL, EngineConfig(**kw))
    reqs = [Request.from_prompt(i, q.copy(), max_new=10)
            for i, q in enumerate(prompts)]
    for r in reqs:
        roomy.submit(r)
    roomy.run_until_done()
    assert out[0][0] == [list(r.generated) for r in reqs]


def test_no_write_lands_in_a_shared_page(monkeypatch):
    """Every K/V write of prefill chunks, decode steps, decode blocks
    and speculative verify passes, with the cache and speculation on,
    lands outside the pages the cache owns at that moment: a hit span is
    full-page aligned and strictly inside the prompt, and the rejected
    lanes of a verify pass write past the accepted position only."""
    writes = {"n": 0, "shared": 0}
    eng = InferenceEngine(MODEL, EngineConfig(
        n_slots=4, max_len=64, prefill_batch=2, page_size=4, chunk_size=8,
        decode_block=4, prefix_cache=True, spec_decode=True,
        max_spec_len=4))
    real = tbuild.attn.update_paged_cache

    def guarded(k_pages, v_pages, index, k_new, v_new):
        _, phys, _ = index
        owned = set(eng.prefix._entries)
        writes["n"] += int(phys.numel())
        writes["shared"] += sum(int(p) in owned for p in phys.tolist())
        return real(k_pages, v_pages, index, k_new, v_new)

    monkeypatch.setattr(tbuild.attn, "update_paged_cache", guarded)
    base = np.array([3, 5, 7, 11, 13] * 4, np.int32)
    prompts = [np.concatenate([base, base[:k + 1]]) for k in range(5)]
    first = Request.from_prompt(0, prompts[0].copy(), max_new=16)
    eng.submit(first)
    eng.run_until_done()
    rest = [Request.from_prompt(i, p.copy(), max_new=16)
            for i, p in enumerate(prompts[1:], 1)]
    for r in rest:
        eng.submit(r)
    eng.run_until_done()
    assert all(len(r.generated) == 16 for r in [first, *rest])
    assert all(r.prefix_hit_tokens > 0 for r in rest)
    assert eng.n_spec_dispatches > 0 and writes["n"] > 0
    assert writes["shared"] == 0


def test_engine_prefix_cache_refusals_match_jax():
    """Slot plane and a Mamba-2 model: the JAX engine's ValueError,
    word for word."""
    mcfg = get_smoke_config("mamba2-2.7b")
    jm = jax_build(jax_smoke("mamba2-2.7b"))
    jp = jm.init(jax.random.key(0))
    mamba = Model(mcfg, device="cpu")
    mamba.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp),
                                          mcfg))
    for model, jmodel, jparams, kw in (
        (MODEL, JMODEL, JPARAMS, dict(n_slots=2, max_len=32, paged=False,
                                      prefix_cache=True)),
        (mamba, jm, jp, dict(n_slots=2, max_len=32, prefix_cache=True)),
    ):
        with pytest.raises(ValueError) as want:
            JEngine(jmodel, jparams, JEngineConfig(**kw), fn_cache={})
        with pytest.raises(ValueError) as got:
            InferenceEngine(model, EngineConfig(**kw))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Engine-plane Cluster, against the JAX Cluster
# ---------------------------------------------------------------------------

def _spaced(reqs, gap=20.0):
    """Arrivals ``gap`` seconds apart, far beyond a request's service
    time even on a loaded host, and SLOs no measured step time can
    miss: every later group-mate sees the published prefix, and neither
    the schedule nor the Dispatcher's admission verdict depends on how
    fast the host ran (the cluster's clock skips idle time, so the gap
    costs nothing)."""
    for i, r in enumerate(reqs):
        r.arrival = gap * i
        r.ttft_slo = r.tpot_slo = 100.0
    return reqs


def _pd_workload(make):
    return _spaced(make(task="gsm8k", n=6, qps=2.0, seed=3, n_groups=2,
                        shape="chat", prefix_len=16, suffix_len=4, l_out=3))


def _port_cluster(**kw):
    cfg = ClusterConfig(model=SMOKE, backend="engine", policy="hyperflexis",
                        seed=0, engine=EngineConfig.smoke(), **kw)
    return Cluster(cfg, device="cpu", seed_params=SEED_PARAMS)


def _jax_cluster(**kw):
    cfg = jcluster.ClusterConfig(model=jax_smoke("qwen7b"),
                                 backend="engine", policy="hyperflexis",
                                 seed=0, engine=JEngineConfig.smoke(), **kw)
    return jcluster.Cluster(cfg)


PD = dict(mode="pd", n_prefill=1, n_decode=1)


def test_engine_pd_cluster_prefix_cache_token_identity():
    """P/D migration of cache-hit requests (tables of shared and private
    pages exported and imported) preserves tokens: the same with the
    cache off, and equal to the JAX Cluster's, with equal prefix
    stats."""
    reqs_on = _pd_workload(shared_prefix_workload)
    res_on = _port_cluster(prefix_cache=True, **PD).run(reqs_on)
    reqs_off = _pd_workload(shared_prefix_workload)
    _port_cluster(prefix_cache=False, **PD).run(reqs_off)
    jreqs = _pd_workload(jshared_prefix_workload)
    jres = _jax_cluster(prefix_cache=True, **PD).run(jreqs)
    tokens = [list(r.generated) for r in reqs_on]
    assert tokens == [list(r.generated) for r in reqs_off]
    assert tokens == [list(r.generated) for r in jreqs]
    assert all(r.state == RequestState.FINISHED for r in reqs_on)
    assert res_on.prefix_stats == jres.prefix_stats
    assert res_on.prefix_stats["n_hit_tokens"] > 0
    assert res_on.metrics.prefix_hit_tokens == jres.metrics.prefix_hit_tokens
    assert [r.prefix_hit_tokens for r in reqs_on] == \
           [r.prefix_hit_tokens for r in jreqs]
    # at least one migrated request rode on cached pages
    assert any(r.prefix_hit_tokens > 0 and r.decode_worker is not None
               and r.decode_worker != r.prefill_worker for r in reqs_on)
    assert res_on.n_prefill_tokens == jres.n_prefill_tokens > 0


def test_metrics_schema_has_prefix_fields_on_both_planes():
    sim = Cluster(ClusterConfig(
        model=get_config("qwen7b"), n_workers=1, policy="hyperflexis",
        seed=0, prefix_cache=True)).run(
            shared_prefix_workload(task="gsm8k", n=6, qps=8, seed=1,
                                   n_groups=2, prefix_len=64,
                                   suffix_len=8))
    reqs = _pd_workload(shared_prefix_workload)
    eng = _port_cluster(n_workers=1, prefix_cache=True).run(reqs)
    jreqs = _pd_workload(jshared_prefix_workload)
    jeng = _jax_cluster(n_workers=1, prefix_cache=True).run(jreqs)
    a, b = sim.metrics.row(), eng.metrics.row()
    assert set(a) == set(b) == set(jeng.metrics.row())
    assert "prefix_hit_tokens" in a and "prefix_hit_rate" in a
    assert dataclasses.asdict(sim.metrics).keys() == \
           dataclasses.asdict(eng.metrics).keys()
    assert eng.metrics.prefix_hit_tokens > 0
    assert eng.prefix_stats == jeng.prefix_stats
    assert [list(r.generated) for r in reqs] == \
           [list(r.generated) for r in jreqs]


def test_engine_admission_full_hit_admitted_where_cold_rejects():
    """After a shared-prefix run the replica's cache holds the group's
    32-token prefix: ``prefix_peek`` sees it (as the JAX replica does),
    and the Dispatcher admits the warm request under a TTFT SLO that it
    refuses the cold one.  The profiler is fitted from the run's step
    times, then pinned to fixed coefficients before the verdicts: a CPU
    prefill of 1 to 16 tokens is almost all fixed overhead, so on a
    loaded host the fitted slope is noise and can clamp to 0, leaving a
    33-token prefill priced as a 1-token one."""
    def wl(make):
        return _spaced(make(task="gsm8k", n=5, qps=2.0, seed=2, n_groups=1,
                            shape="chat", prefix_len=32, suffix_len=4,
                            l_out=2))

    cluster = _port_cluster(n_workers=1, prefix_cache=True)
    reqs = wl(shared_prefix_workload)
    cluster.run(reqs)
    jc = _jax_cluster(n_workers=1, prefix_cache=True)
    jreqs = wl(jshared_prefix_workload)
    jc.run(jreqs)
    assert [list(r.generated) for r in reqs] == \
           [list(r.generated) for r in jreqs]
    assert (cluster.workers[0].engine.prefix.stats()
            == jc.workers[0].engine.prefix.stats())
    assert cluster.fitted.fit(min_samples=4)
    # 2 ms a prefill plus 0.1 ms a token; 1 ms a decode step plus 0.1 ms
    # a sequence: a 33-token prefill costs 5.3 ms, a 1-token one 2.1 ms
    k = cluster.fitted.coeffs
    k.a, k.b, k.c = 2e-3, 1e-4, 0.0
    k.a_d, k.b_d, k.c_d = 1e-3, 1e-6, 1e-4
    now = cluster.now
    seed = cluster.cfg.seed
    peeks = []
    for c, make, mat in ((cluster, Request, materialize_prompts),
                         (jc, JRequest, jmaterialize)):
        warm = make(rid=900, task="gsm8k", arrival=now, l_in=33, l_out=2,
                    prefix_group=0, prefix_len=32)
        mat([warm], SMOKE.vocab_size, seed=seed)
        cold = make(rid=901, task="gsm8k", arrival=now, l_in=33, l_out=2)
        mat([cold], SMOKE.vocab_size, seed=123)
        peeks.append((c.workers[0].prefix_peek(warm),
                      c.workers[0].prefix_peek(cold)))
        if c is cluster:
            w_req, c_req = warm, cold
    assert peeks == [(32, 0), (32, 0)]
    e_cold = cluster.fitted.prefill_time([33])
    e_warm = cluster.fitted.prefill_time([1])
    assert e_warm / 0.9 < e_cold
    slo = 0.5 * (e_warm / 0.9 + e_cold)
    w_req.ttft_slo = c_req.ttft_slo = slo
    v_warm = cluster.policy.admission_verdict(w_req, now)
    v_cold = cluster.policy.admission_verdict(c_req, now)
    assert not v_cold.admit
    assert v_warm.admit and v_warm.p > v_cold.p
