"""SLO-customized speculative decoding on the port's paged plane,
against the JAX package on the same weights.

``Model.spec_decode_block`` against JAX's on the same caches and
proposals (tokens, valid lanes, final last/pos equal; pools within
1e-4); then the engine cases of ``tests/test_spec_decode.py`` — token
identity with plain decoding across page / chunk sizes and with fixed-K
blocks, EOS, depth from TPOT slack, P/D export and migration of a
speculating request, warm-up of every verify bucket — each also holding
the speculative counters (dispatches, proposed, accepted, depth
histogram, per-task stats) equal to the JAX engine's; and an
engine-plane ``Cluster(spec_decode=True)`` with every request's tokens
and the counters equal to the JAX ``Cluster``'s.

f32 on the CPU.  Both engines schedule deterministically (no profiler
fit unless a case injects the same fitted one into both), so the same
requests see the same proposals, verify passes and rollbacks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import latency_model as jlm  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving.cluster import Cluster as JCluster  # noqa: E402
from repro.serving.cluster import ClusterConfig as JClusterConfig  # noqa
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import latency_model as tlm  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cluster import Cluster, ClusterConfig  # noqa: E402
from repro_torch.serving.engine import EngineConfig, InferenceEngine  # noqa
from repro_torch.serving.kv_manager import PagedKVManager  # noqa: E402

CFG = get_smoke_config("qwen7b")
JMODEL = jax_build(jax_smoke("qwen7b"))
JPARAMS = JMODEL.init(jax.random.key(0))
SEED_PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), CFG)
MODEL = Model(CFG, device="cpu")
MODEL.load_state_dict(SEED_PARAMS)
_FN_CACHE: dict = {}   # jitted JAX steps shared by every JAX engine below
_JIT = {"chunk": jax.jit(JMODEL.chunk_step),
        "block": jax.jit(JMODEL.decode_block, static_argnames="k"),
        "spec": jax.jit(JMODEL.spec_decode_block, static_argnames="k")}

# the spec counters both engines keep
COUNTERS = ("n_spec_dispatches", "n_spec_proposed", "n_spec_accepted",
            "spec_depth_hist", "spec_task_stats", "decode_block_hist",
            "n_dispatches", "n_decode_tokens", "n_prefill_tokens")


def _counters(eng) -> dict:
    return {name: getattr(eng, name) for name in COUNTERS}


def _ekw(decode_block=1, page_size=8, chunk_size=16, n_slots=4,
         max_len=48, **kw):
    return dict(n_slots=n_slots, max_len=max_len, prefill_batch=2,
                page_size=page_size, chunk_size=chunk_size,
                decode_block=decode_block, **kw)


def _spec_ekw(page_size=8, chunk_size=16, n_slots=4, max_len=48,
              max_spec_len=4, **kw):
    return _ekw(1, page_size, chunk_size, n_slots, max_len,
                spec_decode=True, max_spec_len=max_spec_len, **kw)


def _engines(profiler=None, jprofiler=None, **ekw):
    """(port engine, JAX engine) of one config on the same weights."""
    return (InferenceEngine(MODEL, EngineConfig(**ekw), profiler=profiler),
            JEngine(JMODEL, JPARAMS, JEngineConfig(**ekw),
                    profiler=jprofiler, fn_cache=_FN_CACHE))


def _rep_prompts():
    """Prompts with enough self-repetition for the drafter to fire
    (plus one fully random control) — those of test_spec_decode.py."""
    rng = np.random.default_rng(7)
    return [
        np.array([3, 5, 7, 11] * 3, np.int32),
        np.array([2, 4] * 5, np.int32),
        np.array([9] * 8, np.int32),
        rng.integers(0, CFG.vocab_size, size=9).astype(np.int32),
    ]


def _run(eng, make_req, prompts, max_new=10, **req_kw):
    reqs = [make_req(i, p.copy(), max_new=max_new, **req_kw)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.finish_time is not None for r in reqs)
    return reqs


def _run_both(prompts, max_new=10, profilers=(None, None), **ekw):
    """The same requests through both engines: (port tokens, JAX
    tokens, port engine, JAX engine), the counters already held
    equal."""
    eng, jeng = _engines(*profilers, **ekw)
    got = [r.generated for r in _run(eng, Request.from_prompt, prompts,
                                     max_new)]
    want = [r.generated for r in _run(jeng, JRequest.from_prompt, prompts,
                                      max_new)]
    assert got == want
    assert _counters(eng) == _counters(jeng)
    return got, want, eng, jeng


# ---------------------------------------------------------------------------
# Model.spec_decode_block against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_decode_block_matches_jax(k):
    """Same caches, same proposals: row 0 proposes greedy decode's own
    continuation (every lane accepted), row 1 its first token and then
    a wrong one, row 2 nothing (a plain decode lane), row 3 is idle.
    Run once with room and once with row 0 stopping on its output
    budget and row 1 on EOS inside the span."""
    ps, b, max_len = 4, 4, 40
    rng = np.random.default_rng(k)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in (9, 6, 11)]

    def fresh():
        kv = PagedKVManager(b, max_len, ps, device="cpu")
        jc = JMODEL.init_paged_cache(b, max_len, ps)
        tc = MODEL.init_paged_cache(b, max_len, ps)
        tokens = np.zeros((b, 11), np.int32)
        lens = np.zeros(b, np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            lens[i] = len(p)
            assert kv.ensure(i, len(p) + k + 1)
        args = (kv.table, tokens, np.zeros(b, np.int32), lens)
        lj, jc = _JIT["chunk"](JPARAMS, jc, *map(jnp.asarray, args))
        MODEL.chunk_step(tc, *map(torch.as_tensor, args))
        return kv, jc, tc, np.asarray(lj).argmax(-1).astype(np.int32), lens

    kv, jc, _, last, pos = fresh()
    alive = np.array([True, True, True, False])
    # greedy decode's own continuation, from a copy of JAX's caches
    (greedy, *_), _ = _JIT["block"](
        JPARAMS, jc, jnp.asarray(kv.table), *map(jnp.asarray, (
            last, pos, alive, np.full(b, 64, np.int32))),
        jnp.int32(-1), jnp.int32(max_len), k=k)
    greedy = np.asarray(greedy)
    props = np.zeros((b, k), np.int32)
    props[0] = greedy[0]
    props[1] = greedy[1]
    if k > 1:
        props[1, 1] = (greedy[1, 1] + 1) % CFG.vocab_size
    prop_lens = np.array([k, k, 0, 0], np.int32)

    def run(eos, rem):
        kv, jc, tc, last, pos = fresh()
        args = (last, pos, alive, rem)
        (jt, jv, jl, jp), jc = _JIT["spec"](
            JPARAMS, jc, jnp.asarray(kv.table), *map(jnp.asarray, args),
            jnp.int32(eos), jnp.int32(max_len), jnp.asarray(props),
            jnp.asarray(prop_lens), k=k)
        (tt, tv, tl, tp), tc = MODEL.spec_decode_block(
            tc, torch.as_tensor(kv.table), *map(torch.as_tensor, args),
            eos, max_len, torch.as_tensor(props),
            torch.as_tensor(prop_lens), k=k)
        for got, want in ((tt, jt), (tv, jv), (tl, jl), (tp, jp)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tc[0][name].numpy(),
                                       np.asarray(jc[0][name]),
                                       rtol=1e-4, atol=1e-4)
        return tt.numpy(), tv.numpy(), tp.numpy()

    toks, valid, new_pos = run(-1, np.full(b, 64, np.int32))
    assert valid[0].all()                          # every lane accepted
    assert valid[1].sum() == min(2, k + 1)         # one match, then a miss
    assert valid[2].sum() == 1 and not valid[3].any()
    np.testing.assert_array_equal(new_pos, pos + valid.sum(1))
    eos = int(toks[1, 0])
    toks, valid, _ = run(eos, np.array([1, 64, 64, 0], np.int32))
    assert valid[0].sum() == 1                     # output budget of 1
    assert valid[1].sum() == 1                     # EOS on lane 0


# ---------------------------------------------------------------------------
# Engine: token identity and counters against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size,chunk_size", [(4, 8), (8, 16)])
def test_spec_token_identical_to_plain(page_size, chunk_size):
    base = _run(InferenceEngine(MODEL, EngineConfig(
        **_ekw(1, page_size, chunk_size))), Request.from_prompt,
        _rep_prompts(), max_new=12)
    got, _, eng, _ = _run_both(_rep_prompts(), max_new=12,
                               **_spec_ekw(page_size, chunk_size))
    assert got == [r.generated for r in base]
    # speculation fired and accounting balances
    assert eng.n_spec_dispatches > 0
    assert eng.n_spec_proposed >= eng.n_spec_accepted >= 0
    assert sum(eng.spec_depth_hist.values()) == eng.n_spec_dispatches
    assert eng.kv.n_free_pages == eng.kv.n_pages


def test_spec_identical_to_fixed_k_blocks():
    blk = _run(InferenceEngine(MODEL, EngineConfig(**_ekw(8))),
               Request.from_prompt, _rep_prompts(), max_new=12)
    got, _, _, _ = _run_both(_rep_prompts(), max_new=12, **_spec_ekw())
    assert got == [r.generated for r in blk]


def test_spec_eos_stops_identically():
    (base,) = _run(InferenceEngine(MODEL, EngineConfig(**_ekw(n_slots=1))),
                   Request.from_prompt, _rep_prompts()[:1], max_new=12)
    tokens = base.generated
    eos = tokens[5]
    want = tokens[: tokens.index(eos) + 1]
    got, _, eng, _ = _run_both(_rep_prompts()[:1], max_new=12,
                               **_spec_ekw(n_slots=1, eos_token=int(eos)))
    assert got == [want]
    assert eng.kv.n_free_pages == eng.kv.n_pages


def _fitted(lm):
    """A fitted Appendix-A profiler of package ``lm`` (JAX's or the
    port's copy) on synthetic samples from one ground truth."""
    truth = lm.LatencyModel(lm.LatencyCoeffs(0.0, 0.01, 0.0, 0.05, 0.0,
                                             0.0))
    prof = lm.FittedLatencyModel()
    for lens in ([4], [8], [4, 8], [16], [8, 16], [32], [4, 32], [64]):
        prof.observe_prefill(lens, truth.prefill_time(lens))
        prof.observe_decode(lens, truth.decode_step_time(lens))
    assert prof.fit()
    return prof


def test_spec_depth_follows_tpot_slack():
    """With the same fitted profiler in both engines (never refitted
    during the run), a tight-TPOT tier speculates shallower than a loose
    one — per-task depth stats equal to the JAX engine's."""
    prof, jprof = _fitted(tlm), _fitted(jlm)
    e_d = prof.decode_step_time([24])
    prompts = _rep_prompts()[:2] * 2
    slos = [e_d + 2.0 * prof.b] * 2 + [e_d + 100.0 * prof.b] * 2
    out = []
    for make_req, eng in zip(
            (Request.from_prompt, JRequest.from_prompt),
            _engines(prof, jprof, **_spec_ekw(max_spec_len=8))):
        reqs = [make_req(i, p.copy(), max_new=12, tpot_slo=t,
                         task="tight" if i < 2 else "loose")
                for i, (p, t) in enumerate(zip(prompts, slos))]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        out.append(([r.generated for r in reqs], _counters(eng)))
    assert out[0] == out[1]
    stats = out[0][1]["spec_task_stats"]
    depth = {t: s["sum_want"] / s["lanes"] for t, s in stats.items()}
    assert depth["tight"] < depth["loose"]


def test_spec_pd_export_and_migration_identity():
    """Park on a spec prefill engine, migrate, speculate on the
    destination (other page size), export mid-stream, finish on a
    per-token engine: the tokens equal the unmigrated plain run's, and
    each engine's counters equal its JAX counterpart's."""
    prompt = _rep_prompts()[0]
    (base,) = _run(InferenceEngine(MODEL, EngineConfig(
        **_ekw(n_slots=1, max_len=64))), Request.from_prompt,
        [prompt.copy()], max_new=16)
    want = base.generated

    a, ja = _engines(**_spec_ekw(n_slots=1, max_len=64))
    b, jb = _engines(**_spec_ekw(n_slots=1, max_len=64, page_size=4))
    c, jc = _engines(**_ekw(n_slots=1, max_len=64))
    got = []
    for (a_, b_, c_), make_req in (((a, b, c), Request.from_prompt),
                                   ((ja, jb, jc), JRequest.from_prompt)):
        a_.park_on_prefill = True
        r = make_req(0, prompt.copy(), max_new=16)
        a_.submit(r)
        a_.run_until_done()
        assert r.slot in a_.parked
        pay = a_.export_kv(r.rid)
        a_.evict(r.slot)
        assert b_.import_kv(pay, r)
        while len(r.generated) < 15:
            b_.step()
        assert r.generated == want[: len(r.generated)]
        pay2 = b_.export_kv(r.rid)
        assert pay2.n_tokens == int(b_.pos[r.slot])
        b_.evict(r.slot)
        assert b_.kv.n_free_pages == b_.kv.n_pages
        assert c_.import_kv(pay2, r)
        c_.run_until_done()
        assert r.state.name == "FINISHED"
        got.append(r.generated)
    assert got == [want, want]
    assert b.n_spec_dispatches > 0 and b.n_spec_accepted > 0
    for eng, jeng in ((a, ja), (b, jb), (c, jc)):
        assert _counters(eng) == _counters(jeng)


def test_warm_decode_blocks_covers_spec_buckets(monkeypatch):
    """The warm-up runs one verify pass per pow2 proposal width up to
    max_spec_len — the buckets the JAX engine compiles — and leaves the
    engine as it was."""
    eng, jeng = _engines(**_ekw(4, spec_decode=True, max_spec_len=4))
    widths = []
    real = MODEL.spec_decode_block

    def record(*args, k):
        widths.append(k)
        return real(*args, k=k)

    monkeypatch.setattr(MODEL, "spec_decode_block", record)
    before = [t.clone() for t in eng.caches[0].values()]
    eng.warm_decode_blocks()
    jeng.warm_decode_blocks()
    assert widths == [1, 2, 4]
    assert set(widths) == set(jeng._spec_fns)
    for t, t0 in zip(eng.caches[0].values(), before):
        assert torch.equal(t, t0)
    assert eng.n_spec_dispatches == 0 and not eng.spec_depth_hist
    monkeypatch.undo()
    got = _run(eng, Request.from_prompt, _rep_prompts(), max_new=12)
    want = _run(jeng, JRequest.from_prompt, _rep_prompts(), max_new=12)
    assert [r.generated for r in got] == [r.generated for r in want]


def test_spec_decode_refusals_match_jax():
    """Slot plane, a Mamba-2 model and a depth below 1: the JAX
    engine's ValueError, word for word."""
    mcfg = get_smoke_config("mamba2-2.7b")
    jm = jax_build(jax_smoke("mamba2-2.7b"))
    jp = jm.init(jax.random.key(0))
    mamba = Model(mcfg, device="cpu")
    mamba.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp),
                                          mcfg))
    assert not mamba.supports_spec_decode and MODEL.supports_spec_decode
    for model, jmodel, jparams, kw in (
        (MODEL, JMODEL, JPARAMS, _spec_ekw(paged=False)),
        (mamba, jm, jp, _spec_ekw()),
        (MODEL, JMODEL, JPARAMS, _spec_ekw(max_spec_len=0)),
    ):
        with pytest.raises(ValueError) as want:
            JEngine(jmodel, jparams, JEngineConfig(**kw), fn_cache={})
        with pytest.raises(ValueError) as got:
            InferenceEngine(model, EngineConfig(**kw))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Engine-plane Cluster with speculation on every replica
# ---------------------------------------------------------------------------

def _cluster_reqs(make):
    """Four repetitive prompts arriving together with loose SLOs: the
    Dispatcher places them at once, so each replica's schedule does not
    depend on measured step times."""
    return [make(rid=i, task="chat", arrival=0.0, l_in=len(p), l_out=12,
                 ttft_slo=100.0, tpot_slo=100.0, prompt=p.copy())
            for i, p in enumerate(_rep_prompts())]


def test_engine_cluster_spec_decode_matches_jax():
    """``Cluster(backend="engine", spec_decode=True)``: every replica
    speculates (the override reaches its EngineConfig), the warm-up ran
    the verify buckets on its throwaway engine, and the tokens and the
    summed counters equal the JAX Cluster's.  ``max_spec_len`` 2 equals
    the controller's unfitted depth, and ``slo_aware=False`` keeps the
    chunk budget off the fit, so the depth and the schedule are the
    same before and after the profiler fits measured times."""
    out = []
    for C, CC, EC, make, kw in (
        (Cluster, ClusterConfig, EngineConfig, Request,
         dict(device="cpu", seed_params=SEED_PARAMS)),
        (JCluster, JClusterConfig, JEngineConfig, JRequest, {}),
    ):
        cfg = CC(model=CFG if C is Cluster else jax_smoke("qwen7b"),
                 backend="engine", n_workers=1, policy="hyperflexis",
                 seed=0, engine=EC(**_ekw(slo_aware=False)),
                 spec_decode=True, max_spec_len=2)
        cluster = C(cfg, **kw)
        eng = cluster.workers[0].engine
        assert eng.cfg.spec_decode and eng.cfg.max_spec_len == 2
        reqs = _cluster_reqs(make)
        res = cluster.run(reqs)
        assert res.metrics.n_finished == len(reqs)
        out.append(([list(r.generated) for r in reqs],
                    (res.spec_dispatches, res.spec_proposed,
                     res.spec_accepted),
                    eng.spec_depth_hist, eng.spec_task_stats))
    assert out[0] == out[1]
    assert out[0][1][0] > 0
    plain = Cluster(ClusterConfig(
        model=CFG, backend="engine", n_workers=1, policy="hyperflexis",
        seed=0, engine=EngineConfig(**_ekw(slo_aware=False))),
        device="cpu", seed_params=SEED_PARAMS)
    reqs = _cluster_reqs(Request)
    plain.run(reqs)
    assert [list(r.generated) for r in reqs] == out[0][0]
