"""The engine's decode graph: on the card, the paged plane's decode
iteration is captured once per engine as a CUDA graph and replayed for
every decode iteration it dispatches.

On the CPU (tier 1): no engine captures, every decode step says so, the
served tokens are those of the forced-eager path, and the pieces the
graph rests on (launch counts taken back out of a capture, one device
buffer for the page table, the dispatch span's ``graph``) behave.  On a
CUDA card only: the graph path and the forced-eager path serve identical
tokens with identical launch counts, through fused blocks of K = 1, 2,
4 and 8, rows crossing a page boundary inside a block, slots retired
and re-admitted, a recompute preemption and an ``import_kv``, for every
family the paged plane serves; and a replayed dispatch makes no host
sync.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.models.build import seeded_model  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import tracing  # noqa: E402
from repro_torch.serving.engine import EngineConfig, InferenceEngine  # noqa
from repro_torch.serving.kv_manager import PagedKVManager  # noqa: E402

CFG = get_smoke_config("qwen7b")
LENS = (5, 11, 3, 17, 9, 6)        # six requests through four slots
L_OUT = (14, 9, 19, 6, 12, 16)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _serve(model, prompts, l_outs, *, eager: bool, **ekw):
    """Serve the requests to completion on a fresh engine, the launch
    counts set to 0 first; returns (tokens, engine, launches, events)."""
    eng = InferenceEngine(model, EngineConfig.smoke(**ekw))
    reqs = [Request.from_prompt(i, p.copy(), n)
            for i, (p, n) in enumerate(zip(prompts, l_outs))]
    for r in reqs:
        eng.submit(r)
    ops.reset_launch_counts()
    events = []
    with engine_mod._forced_eager() if eager else contextlib.nullcontext():
        for _ in range(2000):
            if not (eng.queue or eng.active or eng.prefilling):
                break
            events.append(eng.step())
    assert all(len(r.generated) == r.l_out for r in reqs)
    return [r.generated for r in reqs], eng, ops.launch_counts(), events


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

CPU_MODEL = seeded_model(CFG, "cpu", 0)


@pytest.mark.parametrize("decode_block", [1, 8])
def test_cpu_engine_builds_no_decode_graph(decode_block):
    """The CPU decodes eagerly: no capture, ``decode_graph_iters`` 0 of
    every decode iteration counted, each decode step's ``graph`` False,
    and the tokens those of the forced-eager path."""
    prompts = _prompts(CFG, LENS)
    got, eng, _, events = _serve(CPU_MODEL, prompts, L_OUT, eager=False,
                                 decode_block=decode_block)
    want, _, _, _ = _serve(CPU_MODEL, prompts, L_OUT, eager=True,
                           decode_block=decode_block)
    assert got == want
    assert eng._graph is None and eng.decode_graph_iters == 0
    assert eng.decode_iters == sum(
        k * n for k, n in eng.decode_block_hist.items()) > 0
    decode = [e for e in events if e["kind"] == "decode"]
    assert decode and all(e["graph"] is False for e in decode)
    eng.warm_decode_blocks()
    assert eng._graph is None


def test_forced_eager_nests_and_unwinds():
    with engine_mod._forced_eager():
        with engine_mod._forced_eager():
            assert engine_mod._EAGER_ONLY[0] == 2
        with pytest.raises(KeyError):
            with engine_mod._forced_eager():
                raise KeyError
        assert engine_mod._EAGER_ONLY[0] == 1
    assert engine_mod._EAGER_ONLY[0] == 0


def test_uncounted_launches_are_taken_back_and_reported(monkeypatch):
    """A capture's launches leave the counts as they were and are
    reported by kernel; ``add_launches`` adds a replay's."""
    class FakeLib:
        def paged_kv_write_launch(self, *args):
            return 0

        def paged_decode_attention_launch(self, *args):
            return 0

    monkeypatch.setattr(_build, "library", lambda name: FakeLib())
    ops.reset_launch_counts()
    _build.launch("paged_kv_write")
    with _build.uncounted() as made:
        for _ in range(3):
            _build.launch("paged_kv_write")
        _build.launch("paged_decode_attention")
        assert ops.launch_counts()["paged_kv_write"] == 4
    assert made == {"paged_kv_write": 3, "paged_decode_attention": 1}
    assert ops.launch_counts()["paged_kv_write"] == 1
    assert ops.launch_counts()["paged_decode_attention"] == 0
    _build.add_launches({name: 2 * n for name, n in made.items()})
    assert ops.launch_counts()["paged_kv_write"] == 7
    assert ops.launch_counts()["paged_decode_attention"] == 2
    ops.reset_launch_counts()


def test_device_table_uploads_into_one_buffer():
    """Every upload of the table lands in the buffer a captured graph
    reads; each change still gives a new tensor, and no change none."""
    kv = PagedKVManager(n_slots=2, max_len=16, page_size=4, device="cpu")
    t0 = kv.device_table()
    assert kv.device_table() is t0
    assert kv.ensure(1, 9)
    t1 = kv.device_table()
    assert t1 is not t0 and t1.data_ptr() == t0.data_ptr()
    assert np.array_equal(t1.numpy(), kv.table)
    kv.release(1)
    t2 = kv.device_table()
    assert t2.data_ptr() == t0.data_ptr() and (t2 == -1).all()


def test_dispatch_spans_say_whether_they_replayed():
    """Each ``engine.dispatch`` span carries ``graph``: 0 on the CPU."""
    prompts = _prompts(CFG, LENS[:3])
    tracing.enable()
    try:
        _serve(CPU_MODEL, prompts, L_OUT[:3], eager=False)
        spans = tracing.drain()
    finally:
        tracing.disable()
    dispatch = [s for s in spans if s.name == "engine.dispatch"]
    assert dispatch and all(s.attrs["graph"] == 0 for s in dispatch)


# ---------------------------------------------------------------------------
# CUDA card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_model(cuda):
    return seeded_model(CFG, cuda, 0)


def _both(model, prompts, l_outs, **ekw):
    """The graph path against the forced-eager path: identical tokens
    and launch counts; every decode iteration of the graph engine
    replayed, none of the eager one's."""
    got, g_eng, g_launch, g_ev = _serve(model, prompts, l_outs, eager=False,
                                        **ekw)
    want, e_eng, e_launch, _ = _serve(model, prompts, l_outs, eager=True,
                                      **ekw)
    assert got == want
    assert g_launch == e_launch
    assert g_eng.decode_graph_iters == g_eng.decode_iters > 0
    assert e_eng.decode_graph_iters == 0 and e_eng._graph is None
    assert all(e["graph"] for e in g_ev if e["kind"] == "decode")
    assert g_eng.decode_block_hist == e_eng.decode_block_hist
    return g_eng


@pytest.mark.cuda
@pytest.mark.parametrize("decode_block", [1, 2, 4, 8])
def test_graph_serves_the_eager_paths_tokens(card_model, decode_block):
    """Six requests through four slots (retired and re-admitted), pages
    of 4 tokens, so rows cross page boundaries inside fused blocks."""
    eng = _both(card_model, _prompts(CFG, LENS), L_OUT, page_size=4,
                max_len=48, decode_block=decode_block)
    if decode_block > 1:
        assert max(eng.decode_block_hist) > 1


@pytest.mark.cuda
def test_graph_path_through_a_recompute_preemption(card_model):
    """A pool too small for both rows preempts the younger one while
    they decode; the graph path and the eager path agree."""
    prompts = _prompts(CFG, (10, 10), seed=3)
    eng = _both(card_model, prompts, [14, 14], n_slots=2, max_len=32,
                page_size=4, chunk_size=8, n_pages=7, decode_block=4)
    assert eng.decode_iters > 0


@pytest.mark.cuda
def test_graph_path_after_import_kv(card_model):
    """A request prefilled on a parking engine, exported, evicted and
    imported: the importing engine decodes it through its graph to the
    tokens of the eager path."""
    prompts = _prompts(CFG, (13, 7), seed=5)
    out = []
    for eager in (False, True):
        with (engine_mod._forced_eager() if eager
              else contextlib.nullcontext()):
            a = InferenceEngine(card_model, EngineConfig.smoke(page_size=4))
            a.park_on_prefill = True
            b = InferenceEngine(card_model, EngineConfig.smoke(
                page_size=8, decode_block=4))
            reqs = [Request.from_prompt(i, p.copy(), 11)
                    for i, p in enumerate(prompts)]
            other = Request.from_prompt(9, prompts[1][::-1].copy(), 15)
            b.submit(other)
            for _ in range(3):
                b.step()    # b decodes before the hand-off lands
            for r in reqs:
                a.submit(r)
            a.run_until_done()
            for r in reqs:
                payload = a.export_kv(r.rid)
                a.evict(r.slot)
                assert b.import_kv(payload, r)
            b.run_until_done()
            out.append(([r.generated for r in [*reqs, other]],
                        b.decode_graph_iters))
    (got, replayed), (want, none) = out
    assert got == want and replayed > 0 and none == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b",
                                  "olmoe-1b-7b"])
def test_graph_serves_every_paged_family(cuda, arch):
    """The SSM, the hybrid and the MoE FFN capture and replay too."""
    cfg = get_smoke_config(arch)
    model = seeded_model(cfg, cuda, 1)
    _both(model, _prompts(cfg, LENS[:5], seed=2), L_OUT[:5], decode_block=4)


@pytest.mark.cuda
def test_replayed_dispatch_makes_no_host_sync(card_model, monkeypatch):
    """The graph path's dispatch (its uploads and replays) runs under
    ``set_sync_debug_mode("error")``; the plain route's host-side write
    filter would raise there."""
    real = InferenceEngine._replay_decode
    calls = []

    def strict(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            calls.append(args[-1])

    monkeypatch.setattr(InferenceEngine, "_replay_decode", strict)
    _serve(card_model, _prompts(CFG, LENS), L_OUT, eager=False,
           decode_block=8)
    assert calls and max(calls) > 1      # K = 1 steps and fused blocks
    table = torch.zeros((1, 2), dtype=torch.int32, device=card_model.device)
    positions = torch.zeros((1, 1), dtype=torch.int32,
                            device=card_model.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            from repro_torch.models import attention
            attention.paged_write_index(table, positions, positions == 0, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
