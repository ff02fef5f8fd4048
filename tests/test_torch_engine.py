"""Engine of the PyTorch port against the JAX engine on the same
weights: token-for-token generation across page and chunk sizes, under
preemption, and through the P/D export/import round trip; plus the
allocator invariants on the port's own copy and the engine's refusals.

f32 on the CPU.  Greedy tokens must be identical: both engines
schedule deterministically (no profiler fit in these runs), so the
same requests see the same chunks, blocks and preemptions.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import EngineConfig, InferenceEngine  # noqa
from repro_torch.serving.kv_manager import (  # noqa: E402
    PageAllocator,
    PagedKVManager,
)

CFG = get_smoke_config("qwen7b")
JMODEL = jax_build(jax_smoke("qwen7b"))
JPARAMS = JMODEL.init(jax.random.key(0))
MODEL = Model(CFG, device="cpu")
MODEL.load_state_dict(params_from_jax(jax.tree.map(np.asarray, JPARAMS),
                                      CFG))
_FN_CACHE: dict = {}   # jitted JAX steps shared by every JAX engine


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in lens]


def _serve_both(prompts, max_new, **ekw):
    """Run the same requests through both engines; return (port, jax)
    generated tokens and the two engines."""
    out = []
    for make_req, engine in (
        (Request.from_prompt,
         lambda: InferenceEngine(MODEL, EngineConfig(**ekw))),
        (JRequest.from_prompt,
         lambda: JEngine(JMODEL, JPARAMS, JEngineConfig(**ekw),
                         fn_cache=_FN_CACHE)),
    ):
        eng = engine()
        reqs = [make_req(i, p.copy(), m)
                for i, (p, m) in enumerate(zip(prompts, max_new))]
        for r in reqs:
            eng.submit(r)
        fin = eng.run_until_done(max_steps=500)
        assert len(fin) == len(reqs)
        assert eng.kv.n_free_pages == eng.kv.n_pages
        out.append(([r.generated for r in reqs], eng))
    return out


@pytest.mark.parametrize("page_size,chunk_size",
                         list(itertools.product([4, 8], [8, 16])))
def test_engine_tokens_match_jax(page_size, chunk_size):
    prompts = _prompts(page_size * chunk_size, (13, 5, 21, 9, 3))
    max_new = [6, 9, 4, 7, 5]
    (got, eng), (want, jeng) = _serve_both(
        prompts, max_new, n_slots=3, max_len=40, prefill_batch=2,
        page_size=page_size, chunk_size=chunk_size)
    assert got == want
    assert [len(g) for g in got] == max_new
    # same schedule, step for step
    assert eng.decode_block_hist == jeng.decode_block_hist
    assert eng.n_dispatches == jeng.n_dispatches
    assert eng.n_prefill_tokens == jeng.n_prefill_tokens


@pytest.mark.parametrize("n_pages", [4, 5])
def test_engine_preemption_matches_jax(n_pages):
    """An oversubscribed pool recompute-preempts the youngest request
    (4 pages: at prefill; 5: when decode grows) — tokens still equal
    the JAX engine's and those of a pool with room for both."""
    prompts = _prompts(3, (10, 10))
    kw = dict(n_slots=2, max_len=16, prefill_batch=2, page_size=4,
              chunk_size=8)
    (got, _), (want, _) = _serve_both(prompts, [6, 6], n_pages=n_pages,
                                      **kw)
    roomy = InferenceEngine(MODEL, EngineConfig(**kw))
    reqs = [Request.from_prompt(i, p.copy(), 6) for i, p in enumerate(prompts)]
    for r in reqs:
        roomy.submit(r)
    roomy.run_until_done()
    assert got == want == [r.generated for r in reqs]


def _pd_req(rid=0, l_in=20, max_new=8):
    prompt = (np.arange(l_in, dtype=np.int32) * 7 + rid) % CFG.vocab_size
    return Request.from_prompt(rid, prompt.astype(np.int32), max_new)


def _engine(page_size=8, chunk_size=16):
    return InferenceEngine(MODEL, EngineConfig(
        n_slots=4, max_len=48, prefill_batch=2, page_size=page_size,
        chunk_size=chunk_size))


def _baseline(page_size=8, chunk_size=16):
    e = _engine(page_size, chunk_size)
    r = _pd_req()
    e.submit(r)
    e.run_until_done()
    assert len(r.generated) == 8
    return r.generated


@pytest.mark.parametrize("page_size,chunk_size", [(4, 8), (8, 16), (4, 16)])
def test_export_import_roundtrip_token_identity(page_size, chunk_size):
    """Prefill on A (parked), export, evict, import on B, decode there:
    the tokens equal the unmigrated run's."""
    want = _baseline(page_size, chunk_size)

    a = _engine(page_size, chunk_size)
    a.park_on_prefill = True
    r = _pd_req()
    a.submit(r)
    a.run_until_done()
    assert r.slot in a.parked and not a.active
    assert r.generated == want[:1]
    payload = a.export_kv(r.rid)
    assert payload.n_tokens == len(r.prompt)
    assert a.kv_bytes_of(r.rid) == payload.nbytes
    a.evict(r.slot)
    assert a.kv.n_free_pages == a.kv.n_pages
    b = _engine(page_size, chunk_size)
    assert b.import_kv(payload, r)
    b.run_until_done()
    assert r.generated == want
    assert r.state == RequestState.FINISHED


def test_export_import_across_page_sizes_and_mid_decode():
    """The payload is page-layout-free (ps=4 -> ps=8), and a request
    already decoding migrates with its newest tokens."""
    want = _baseline()
    a = _engine(page_size=4)
    a.park_on_prefill = True
    r = _pd_req()
    a.submit(r)
    a.run_until_done()
    payload = a.export_kv(r.rid)
    a.evict(r.slot)
    b = _engine(page_size=8)
    assert b.import_kv(payload, r)
    while len(r.generated) < 3:
        b.step()
    payload = b.export_kv(r.rid)
    assert payload.n_tokens == len(r.prompt) + len(r.generated) - 1
    assert b.kv_bytes_of(r.rid) == payload.nbytes
    b.evict(r.slot)
    c = _engine(page_size=4, chunk_size=8)
    assert c.import_kv(payload, r)
    c.run_until_done()
    assert r.generated == want


def test_engine_refuses_what_is_not_ported():
    for kw in (dict(paged=False), dict(prefix_cache=True),
               dict(spec_decode=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceEngine(MODEL, EngineConfig(**kw))
    eng = InferenceEngine(MODEL, EngineConfig(n_slots=2, max_len=16))
    with pytest.raises(ValueError):
        eng.submit(Request.from_prompt(0, np.zeros(0, np.int32), 2))
    with pytest.raises(ValueError):
        eng.submit(Request.from_prompt(1, np.zeros(16, np.int32), 2))
    small = InferenceEngine(MODEL, EngineConfig(
        n_slots=2, max_len=24, page_size=4, n_pages=2))
    with pytest.raises(ValueError):  # could never fit the pool alone
        small.submit(Request.from_prompt(2, np.zeros(10, np.int32), 4))


def test_release_weights_needs_a_drained_engine():
    eng = _engine()
    eng.submit(_pd_req(max_new=2))
    with pytest.raises(RuntimeError, match="drain"):
        eng.release_weights()
    eng.run_until_done()
    eng.release_weights()
    assert eng.model is None


# ---------------------------------------------------------------------------
# Allocator invariants on the port's copy (mirrors tests/test_paged_kv.py)
# ---------------------------------------------------------------------------


def test_alloc_no_double_allocation():
    a = PageAllocator(n_pages=16, page_size=8)
    seen = set()
    for owner in range(4):
        pages = a.alloc(4, owner=owner)
        assert pages is not None and len(pages) == 4
        assert not (set(pages) & seen)
        seen |= set(pages)
    assert a.n_free == 0
    assert a.alloc(1) is None
    assert seen == set(range(16))


def test_alloc_atomic_on_failure():
    a = PageAllocator(n_pages=4, page_size=8)
    got = a.alloc(3, owner="x")
    assert a.alloc(2) is None
    assert a.n_free == 1
    a.free(got)
    assert a.n_free == 4


def test_full_reclamation_cycles():
    a = PageAllocator(n_pages=8, page_size=4)
    for _ in range(10):
        p1 = a.alloc(5, owner=1)
        p2 = a.alloc(3, owner=2)
        assert p1 is not None and p2 is not None
        a.free(p1)
        a.free(p2)
    assert a.n_free == 8
    assert a.n_used == 0


def test_double_free_asserts():
    a = PageAllocator(n_pages=2, page_size=4)
    p = a.alloc(1)
    a.free(p)
    with pytest.raises(AssertionError):
        a.free(p)


def test_kv_manager_ensure_grow_and_release():
    kv = PagedKVManager(n_slots=2, max_len=32, page_size=8)
    assert kv.max_pages == 4 and kv.n_pages == 8
    assert kv.ensure(0, 1) and len(kv.pages_of(0)) == 1
    assert kv.ensure(0, 8) and len(kv.pages_of(0)) == 1
    assert kv.ensure(0, 9) and len(kv.pages_of(0)) == 2
    assert kv.ensure(0, 32) and len(kv.pages_of(0)) == 4
    assert not kv.ensure(0, 33)
    assert kv.ensure(1, 32)
    assert kv.n_free_pages == 0
    kv.release(0)
    assert kv.n_free_pages == 4
    assert (kv.table[0] == -1).all()
    kv.release(1)
    assert kv.n_free_pages == kv.n_pages


def test_kv_manager_tables_disjoint_and_device_table():
    kv = PagedKVManager(n_slots=4, max_len=16, page_size=4)
    for s in range(4):
        assert kv.ensure(s, 16)
    used = [p for s in range(4) for p in kv.pages_of(s)]
    assert len(used) == len(set(used)) == 16
    t = kv.device_table()
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), kv.table)
    assert kv.device_table() is t          # unchanged table: no re-upload
    kv.release(2)
    assert kv.device_table() is not t
