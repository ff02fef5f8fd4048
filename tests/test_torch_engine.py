"""Engine of the PyTorch port against the JAX engine on the same
weights: token-for-token generation on the paged plane across page and
chunk sizes, under preemption and through the P/D export/import round
trip; on the slot plane for gemma3 (picked by itself) and qwen7b
(``paged=False``) with per-token and fused decode; the SSM and hybrid
on both planes; olmoe (MoE) on both planes and through a P/D
hand-off, with and without capacity drops; qwen2.5-14b and chameleon
on the paged plane; plus the allocator and slot-row invariants on the
port's own copy and the engine's refusals.

f32 on the CPU.  Greedy tokens must be identical: both engines
schedule deterministically (no profiler fit in these runs), so the
same requests see the same chunks, blocks and preemptions.
"""

import dataclasses
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
    clear_rows,
    insert_rows,
)

CFG = get_smoke_config("qwen7b")
JMODEL = jax_build(jax_smoke("qwen7b"))
JPARAMS = JMODEL.init(jax.random.key(0))
MODEL = Model(CFG, device="cpu")
MODEL.load_state_dict(params_from_jax(jax.tree.map(np.asarray, JPARAMS),
                                      CFG))
_FN_CACHE: dict = {}   # jitted JAX steps shared by every qwen7b JAX engine

GEMMA_CFG = get_smoke_config("gemma3-4b")
GEMMA_JMODEL = jax_build(jax_smoke("gemma3-4b"))
GEMMA_JPARAMS = GEMMA_JMODEL.init(jax.random.key(2))
GEMMA = Model(GEMMA_CFG, device="cpu")
GEMMA.load_state_dict(params_from_jax(
    jax.tree.map(np.asarray, GEMMA_JPARAMS), GEMMA_CFG))
_GEMMA_FN_CACHE: dict = {}


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


def test_engine_refuses_what_the_jax_engine_refuses():
    """Refused on the slot plane exactly as the JAX engine refuses them:
    ``paged=True`` on gemma3, prefix cache and spec decode (ValueError,
    word for word), P/D export and import (RuntimeError),
    ``kv_bytes_of`` (None); and requests the engine could never serve.
    On the paged plane both features run (tests/test_torch_prefix_cache.py,
    tests/test_torch_spec_decode.py)."""
    for kw in (dict(prefix_cache=True), dict(spec_decode=True)):
        assert InferenceEngine(MODEL, EngineConfig(**kw)).paged
    for model, jmodel, jparams, kw in (
        (GEMMA, GEMMA_JMODEL, GEMMA_JPARAMS, dict(paged=True)),
        (GEMMA, GEMMA_JMODEL, GEMMA_JPARAMS, dict(prefix_cache=True)),
        (MODEL, JMODEL, JPARAMS, dict(paged=False, prefix_cache=True)),
        (MODEL, JMODEL, JPARAMS, dict(paged=False, spec_decode=True)),
    ):
        with pytest.raises(ValueError) as want:
            JEngine(jmodel, jparams, JEngineConfig(**kw))
        with pytest.raises(ValueError) as got:
            InferenceEngine(model, EngineConfig(**kw))
        assert str(got.value) == str(want.value)
    slot = InferenceEngine(GEMMA, EngineConfig(n_slots=2, max_len=32))
    req = Request.from_prompt(0, np.arange(12, dtype=np.int32), 4)
    slot.submit(req)
    slot.step()                                   # prefilled, decoding
    assert not slot.paged and slot.kv is None
    with pytest.raises(RuntimeError, match="paged plane"):
        slot.export_kv(req.rid)
    with pytest.raises(RuntimeError, match="paged plane"):
        slot.import_kv(None, Request.from_prompt(1, np.zeros(3, np.int32), 2))
    assert slot.kv_bytes_of(req.rid) is None
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
# Slot plane
# ---------------------------------------------------------------------------


def _serve(engine, make_req, prompts, max_new):
    reqs = [make_req(i, p.copy(), m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        engine.submit(r)
    fin = engine.run_until_done(max_steps=500)
    assert len(fin) == len(reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("decode_block", [1, 8])
@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen7b"])
def test_slot_plane_tokens_match_jax(arch, decode_block):
    """gemma3 takes the slot plane by itself (its local layers), qwen7b
    when asked (``paged=False``).  Prompts run past the window of 8, so
    local layers prefill through the band and decode through the ring;
    3 slots for 6 requests, so rows are cleared and reused."""
    if arch == "gemma3-4b":
        model, jmodel, jparams, fn_cache = (GEMMA, GEMMA_JMODEL,
                                            GEMMA_JPARAMS, _GEMMA_FN_CACHE)
        ekw = dict(paged=None)
    else:
        model, jmodel, jparams, fn_cache = MODEL, JMODEL, JPARAMS, _FN_CACHE
        ekw = dict(paged=False)
    ekw.update(n_slots=3, max_len=64, prefill_batch=2,
               decode_block=decode_block)
    prompts = _prompts(decode_block + 1, (13, 5, 21, 9, 3, 17))
    max_new = [6, 9, 4, 12, 5, 7]
    eng = InferenceEngine(model, EngineConfig(**ekw))
    jeng = JEngine(jmodel, jparams, JEngineConfig(**ekw), fn_cache=fn_cache)
    assert eng.paged is jeng.paged is False
    got = _serve(eng, Request.from_prompt, prompts, max_new)
    want = _serve(jeng, JRequest.from_prompt, prompts, max_new)
    assert got == want
    assert [len(g) for g in got] == max_new
    assert eng.decode_block_hist == jeng.decode_block_hist
    assert eng.n_dispatches == jeng.n_dispatches
    assert eng.n_prefill_tokens == jeng.n_prefill_tokens
    assert eng.kv_token_capacity() == jeng.kv_token_capacity() == 3 * 64
    assert eng.slots.n_free == 3
    # every retired row was wiped; idle rows ride along in later decode
    # steps at position 0 (as in JAX), so only slot 0 may hold data
    for cache in eng.caches:
        assert (cache["pos"][:, 1:] == -1).all()
        assert not cache["k"][:, :, 1:].any()


def test_qwen_slot_plane_tokens_identical_to_paged_plane():
    """The monolithic slot plane generates token for token what the
    chunked paged plane generates, for every chunk size (mirrors
    tests/test_decode_consistency.py on the port)."""
    prompts = _prompts(7, (5, 21, 11, 3))

    def run(paged, chunk):
        eng = InferenceEngine(MODEL, EngineConfig(
            n_slots=2, max_len=48, prefill_batch=2, paged=paged,
            chunk_size=chunk, page_size=4))
        out = _serve(eng, Request.from_prompt, prompts, [4] * 4)
        if paged:
            assert eng.kv.n_free_pages == eng.kv.n_pages
        return out

    base = run(paged=False, chunk=32)
    for chunk in (5, 32):
        assert run(paged=True, chunk=chunk) == base, chunk


def test_insert_and_clear_rows_in_place():
    """insert_rows copies prefill rows into chosen slots, clear_rows
    zeroes K/V and sets pos to -1, both in place; page pools (axis
    None) pass through untouched."""
    caches = GEMMA.init_cache(4, 16)
    axes = GEMMA.cache_axes()
    _, new = GEMMA.prefill(torch.arange(16, dtype=torch.int32).reshape(2, 8),
                           torch.tensor([8, 5], dtype=torch.int32),
                           cache_len=16)
    ptrs = [c["k"].data_ptr() for c in caches]
    out = insert_rows(caches, new, axes, [3, 1])
    assert [c["k"].data_ptr() for c in out] == ptrs
    for got, src in zip(out, new):
        for leaf in ("k", "v", "pos"):
            assert torch.equal(got[leaf][3], src[leaf][0])
            assert torch.equal(got[leaf][1], src[leaf][1])
        assert (got["pos"][[0, 2]] == -1).all()
    assert (out[5]["pos"][1] == torch.tensor(
        [0, 1, 2, 3, 4] + [-1] * 11, dtype=torch.int32)).all()
    clear_rows(out, axes, [3])
    for got, src in zip(out, new):
        assert (got["pos"][3] == -1).all() and not got["k"][3].any()
        assert torch.equal(got["v"][1], src["v"][1])
    pools = MODEL.init_paged_cache(2, 8, 4)
    pools[0]["k_pages"].fill_(1.0)
    clear_rows(pools, MODEL.paged_cache_axes(), [0])
    assert (pools[0]["k_pages"] == 1.0).all()


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
    kv = PagedKVManager(n_slots=2, max_len=32, page_size=8, device="cpu")
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
    kv = PagedKVManager(n_slots=4, max_len=16, page_size=4, device="cpu")
    for s in range(4):
        assert kv.ensure(s, 16)
    used = [p for s in range(4) for p in kv.pages_of(s)]
    assert len(used) == len(set(used)) == 16
    t = kv.device_table()
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), kv.table)
    assert kv.device_table() is t          # unchanged table: no re-upload
    kv.release(2)
    assert kv.device_table() is not t


def test_kv_manager_defaults_to_cuda_and_refuses_without_a_card():
    """Like every entry point of the port, the page table lives on CUDA
    unless the caller names the CPU: without a card, no device raises
    instead of quietly holding the table on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVManager(n_slots=2, max_len=32, page_size=8)
    kv = PagedKVManager(n_slots=2, max_len=32, page_size=8, device="cpu")
    assert kv.device == torch.device("cpu")
    assert kv.ensure(0, 9) and kv.device_table().device.type == "cpu"


# ---------------------------------------------------------------------------
# Mamba-2 (mamba2-2.7b) and the hybrid (zamba2-7b) on both planes
# ---------------------------------------------------------------------------

SSM_ARCHS = ["mamba2-2.7b", "zamba2-7b"]
_SSM: dict = {}


def _ssm(arch, use_kernels=False):
    """(port model, JAX model, JAX params, JAX fn_cache) on the same
    weights.  Both models take the same SSD route: the chunked
    ``ssd_scan`` without ``use_kernels``; with it, where the kernel gate
    holds, the sequential ``ssd_ref`` (the port's kernel on the CPU, the
    JAX package's "jnp" kernel oracle)."""
    key = (arch, use_kernels)
    if key not in _SSM:
        cfg = get_smoke_config(arch)
        jm = jax_build(jax_smoke(arch), use_kernels=use_kernels)
        jp = jm.init(jax.random.key(5))
        m = Model(cfg, device="cpu", use_kernels=use_kernels)
        m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
        _SSM[key] = (m, jm, jp, {})
    return _SSM[key]


def _serve_ssm_both(arch, prompts, max_new, use_kernels=False, **ekw):
    model, jm, jp, fc = _ssm(arch, use_kernels)
    eng = InferenceEngine(model, EngineConfig(**ekw))
    jeng = JEngine(jm, jp, JEngineConfig(**ekw), fn_cache=fc)
    got = _serve(eng, Request.from_prompt, prompts, max_new)
    want = _serve(jeng, JRequest.from_prompt, prompts, max_new)
    return got, want, eng, jeng


def _state_rows_clear(eng):
    """Every per-slot cache leaf (Mamba-2 state; on the slot plane also
    attention rows) of a drained engine holds zeros (pos: -1)."""
    for seg, ax in zip(eng.caches, eng.axes):
        for name, leaf in seg.items():
            if ax[name] is not None:
                fill = -1 if leaf.dtype == torch.int32 else 0
                assert (leaf == fill).all(), name


@pytest.mark.parametrize("decode_block", [1, 8])
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_engine_tokens_match_jax(arch, paged, decode_block):
    """Token for token with the JAX engine, and the same schedule, on
    the paged plane (chunks of 8 over pages of 4; SSM state in slot rows,
    a chunk of length 0 freezing it) and on the slot plane (prompts padded
    to 8/16/32, so the SSD gate holds on some prefills); 3 slots for 6
    requests, so rows are released and reused — and zeroed at release."""
    prompts = _prompts(11, (13, 5, 21, 9, 3, 17))
    max_new = [6, 9, 4, 12, 5, 7]
    got, want, eng, jeng = _serve_ssm_both(
        arch, prompts, max_new, n_slots=3, max_len=64, prefill_batch=2,
        paged=paged, page_size=4, chunk_size=8, decode_block=decode_block)
    assert got == want
    assert [len(g) for g in got] == max_new
    assert eng.paged is jeng.paged is paged
    assert eng.decode_block_hist == jeng.decode_block_hist
    assert eng.n_dispatches == jeng.n_dispatches
    assert eng.n_prefill_tokens == jeng.n_prefill_tokens
    if paged:
        assert eng.kv.n_free_pages == eng.kv.n_pages
        _state_rows_clear(eng)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_slot_plane_kernel_route_matches_jax(arch, monkeypatch):
    """``use_kernels`` on both sides: prompts padded to 16 = the smoke
    chunk run the SSD kernel's gate (its plain version on the CPU, the
    JAX package's oracle), the others the chunked scan — tokens still
    identical, and the gate was taken."""
    from repro_torch.kernels import ref
    calls = []
    real = ref.ssd_ref
    monkeypatch.setattr(ref, "ssd_ref",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    prompts = _prompts(12, (13, 9, 5, 11))
    got, want, eng, _ = _serve_ssm_both(
        arch, prompts, [5, 4, 6, 3], use_kernels=True, n_slots=2,
        max_len=48, prefill_batch=2, paged=False, decode_block=8)
    assert got == want
    assert calls and all(shape[1] == 16 for shape in calls)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_preemption_matches_jax(arch):
    """A pool of 5 pages of 4 for two requests of 10 + 6 tokens:
    preempt-youngest releases the victim's pages and zeroes its SSM row,
    recompute restores it — tokens equal the JAX engine's and a roomy
    pool's."""
    prompts = _prompts(3, (10, 10))
    kw = dict(n_slots=2, max_len=16, prefill_batch=2, page_size=4,
              chunk_size=8)
    got, want, eng, _ = _serve_ssm_both(arch, prompts, [6, 6], n_pages=5,
                                        **kw)
    roomy = InferenceEngine(_ssm(arch)[0], EngineConfig(**kw))
    assert got == want == _serve(roomy, Request.from_prompt, prompts, [6, 6])
    _state_rows_clear(eng)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_export_import_carries_state_rows(arch):
    """Port of tests/test_pd_engine.py::test_export_import_carries_ssm_
    state_rows, for the hybrid too: prefill on A (pages of 8), export,
    evict, import on B (pages of 4) — the payload's slot rows land
    intact and the tokens equal the colocated run and the JAX engine's;
    ``kv_bytes_of`` equals the payload's bytes."""
    model, jm, jp, fc = _ssm(arch)

    def eng(ps):
        return InferenceEngine(model, EngineConfig(
            n_slots=2, max_len=48, prefill_batch=2, page_size=ps,
            chunk_size=16))

    prompt = ((np.arange(1, 21, dtype=np.int32) * 3) % 256).astype(np.int32)
    want = _serve(eng(8), Request.from_prompt, [prompt], [6])[0]
    jeng = JEngine(jm, jp, JEngineConfig(n_slots=2, max_len=48,
                                         prefill_batch=2, page_size=8,
                                         chunk_size=16), fn_cache=fc)
    assert want == _serve(jeng, JRequest.from_prompt, [prompt], [6])[0]

    a = eng(8)
    a.park_on_prefill = True
    r = Request.from_prompt(0, prompt, 6)
    a.submit(r)
    a.run_until_done()
    payload = a.export_kv(0)
    assert a.kv_bytes_of(0) == payload.nbytes
    state = next(seg for seg in payload.kv if "ssm" in seg)
    assert state["ssm"].shape[0] == model.n_mamba
    assert state["ssm"].shape[1:] == a.caches[-1]["ssm"].shape[2:]
    pools = [seg for seg in payload.kv if "k_pages" in seg]
    assert len(pools) == (model.n_attn > 0)
    for seg in pools:
        assert seg["k_pages"].shape[0] == model.n_attn
        assert seg["k_pages"].shape[2] == payload.n_tokens
    rows = {k: v.clone() for k, v in state.items()}
    a.evict(r.slot)
    _state_rows_clear(a)
    b = eng(4)  # page-size change must not disturb slot-row state
    assert b.import_kv(payload, r)
    for k, v in rows.items():
        assert torch.equal(b.caches[-1][k].select(1, r.slot), v)
    b.run_until_done()
    assert r.generated == want


def test_mamba_and_zamba_engines_refuse_prefix_cache_and_spec_decode():
    """A model with Mamba-2 layers refuses the prefix cache and spec
    decode on the paged plane with the JAX engine's ValueError, word
    for word."""
    for arch in SSM_ARCHS:
        model, jm, jp, _ = _ssm(arch)
        for kw in (dict(prefix_cache=True), dict(spec_decode=True),
                   dict(paged=False, prefix_cache=True)):
            with pytest.raises(ValueError) as want:
                JEngine(jm, jp, JEngineConfig(**kw))
            with pytest.raises(ValueError) as got:
                InferenceEngine(model, EngineConfig(**kw))
            assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# MoE (olmoe-1b-7b) on both planes; dense qwen2.5-14b and chameleon-34b
# ---------------------------------------------------------------------------

# "jax_test": the capacity factor tests/test_decode_consistency.py takes
# (8: nothing drops); "default": olmoe's 1.25, where assignments drop and
# every row of a call (idle slots and padding lanes too) takes capacity,
# so tokens equal JAX's only if both engines batch the same rows alike
CAPACITY = {"jax_test": 8.0, "default": None}
_FAM: dict = {}


def _fam(arch, capacity="default"):
    """(port model, JAX model, JAX params, JAX fn_cache) on the same
    weights (JAX's for key 3)."""
    key = (arch, capacity)
    if key not in _FAM:
        cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
        if CAPACITY[capacity] is not None:
            cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=CAPACITY[capacity]))
                for c in (cfg, jcfg))
        jm = jax_build(jcfg)
        jp = jm.init(jax.random.key(3))
        m = Model(cfg, device="cpu")
        m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
        _FAM[key] = (m, jm, jp, {})
    return _FAM[key]


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("paged", [True, False])
def test_moe_engine_tokens_match_jax(paged, capacity):
    """olmoe token for token with the JAX engine, and the same schedule,
    on the paged plane (chunks of 8 over pages of 4) and the slot plane
    (``paged=False``), with fused decode blocks of 8; 3 slots for 6
    requests, so rows are released and reused."""
    model, jm, jp, fc = _fam("olmoe-1b-7b", capacity)
    prompts = _prompts(11, (13, 5, 21, 9, 3, 17))
    max_new = [6, 9, 4, 12, 5, 7]
    ekw = dict(n_slots=3, max_len=64, prefill_batch=2, paged=paged,
               page_size=4, chunk_size=8, decode_block=8)
    eng = InferenceEngine(model, EngineConfig(**ekw))
    jeng = JEngine(jm, jp, JEngineConfig(**ekw), fn_cache=fc)
    assert eng.paged is jeng.paged is paged
    got = _serve(eng, Request.from_prompt, prompts, max_new)
    want = _serve(jeng, JRequest.from_prompt, prompts, max_new)
    assert got == want
    assert [len(g) for g in got] == max_new
    assert eng.decode_block_hist == jeng.decode_block_hist
    assert eng.n_dispatches == jeng.n_dispatches
    assert eng.n_prefill_tokens == jeng.n_prefill_tokens
    if paged:
        assert eng.kv.n_free_pages == eng.kv.n_pages


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_export_import_matches_jax(capacity):
    """P/D hand-off of olmoe: prefill on A (pages of 8), export, evict,
    import on B (pages of 4) — in both packages; the port's tokens equal
    JAX's hand-off and the port's colocated run, and ``kv_bytes_of``
    equals the payload's bytes."""
    model, jm, jp, fc = _fam("olmoe-1b-7b", capacity)
    prompt = ((np.arange(1, 21, dtype=np.int32) * 3) % 256).astype(np.int32)
    ekw = dict(n_slots=2, max_len=48, prefill_batch=2, chunk_size=16)
    colocated = _serve(InferenceEngine(model, EngineConfig(
        page_size=8, **ekw)), Request.from_prompt, [prompt], [6])[0]
    out = []
    for make_eng, make_req in (
        (lambda ps: InferenceEngine(model, EngineConfig(page_size=ps,
                                                        **ekw)),
         Request.from_prompt),
        (lambda ps: JEngine(jm, jp, JEngineConfig(page_size=ps, **ekw),
                            fn_cache=fc), JRequest.from_prompt),
    ):
        a = make_eng(8)
        a.park_on_prefill = True
        r = make_req(0, prompt.copy(), 6)
        a.submit(r)
        a.run_until_done()
        payload = a.export_kv(0)
        assert a.kv_bytes_of(0) == payload.nbytes
        a.evict(r.slot)
        b = make_eng(4)
        assert b.import_kv(payload, r)
        b.run_until_done()
        assert b.kv.n_free_pages == b.kv.n_pages
        out.append(list(r.generated))
    assert out[0] == out[1] == colocated
    assert len(colocated) == 6


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "chameleon-34b"])
def test_dense_family_engine_tokens_match_jax(arch):
    """qwen2.5-14b (GQA 4:1 with QKV bias at smoke size) and chameleon
    (``token+vq``: the token path) on the paged plane, token for token
    with the JAX engine and the same schedule, with per-token decode."""
    model, jm, jp, fc = _fam(arch)
    prompts = _prompts(5, (13, 5, 21, 9))
    max_new = [6, 9, 4, 7]
    ekw = dict(n_slots=2, max_len=40, prefill_batch=2, page_size=4,
               chunk_size=8)
    eng = InferenceEngine(model, EngineConfig(**ekw))
    jeng = JEngine(jm, jp, JEngineConfig(**ekw), fn_cache=fc)
    assert eng.paged is jeng.paged is True
    got = _serve(eng, Request.from_prompt, prompts, max_new)
    assert got == _serve(jeng, JRequest.from_prompt, prompts, max_new)
    assert eng.decode_block_hist == jeng.decode_block_hist
    assert eng.n_dispatches == jeng.n_dispatches
