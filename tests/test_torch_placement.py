"""Replica placement on the port: ``WeightManager.placement`` against the
JAX package's, and an engine-plane ``Cluster`` over a list of devices.

JAX's ``WeightManager.placement`` puts replica ``wid`` on
``jax.devices()[wid % n]`` when the host has more than one device, and
returns None (the seed's device) on one.  The port's takes its devices
from the manager's ``devices``; here four ``meta`` devices stand in for
four cards, and their indices must be JAX's device ids, read from JAX
in a subprocess on a 4-device host (``--xla_force_host_platform_
device_count``).  JAX itself runs only in those subprocesses: the card
test below shares this file.  Every attention, SSD and RMSNorm wrapper
hands its launch the operand whose card must be current.

The device-list route: a ``Cluster`` on ``devices=[cpu, cpu]`` serves
exactly as one on ``device="cpu"`` (tokens, hand-offs and their bytes)
colocated, P/D and with a live migration, and every replica's weights
and KV pool lie on its ``placement(wid)``.  Both runs measure every
engine step as the same 5 ms (``steady_clock``): the cluster's clock
advances by measured step times, and a schedule read off the host's
speed would batch, hand off and migrate differently from run to run.
On two or more cards (``cuda``-marked, skipped otherwise) a P/D cluster
on ``[cuda:0, cuda:1]`` serves the one-card run's tokens, and every
kernel call on the second card agrees with its plain version.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.scaler import ScaleAction  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as decode_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_mod  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.serving.cluster import (  # noqa: E402
    Cluster,
    ClusterConfig,
    placed_devices,
)
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.session import ServingSession  # noqa: E402
from repro_torch.serving.weights import WeightManager  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = get_smoke_config("qwen7b")
CPU = torch.device("cpu")

_JAX_PLACEMENT = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           + sys.argv[1])
import jax, numpy as np
from repro.serving.weights import WeightManager

assert len(jax.devices()) == int(sys.argv[1])
wm = WeightManager({"w": np.arange(4, dtype=np.float32).reshape(2, 2)})
ids = []
for wid in range(8):
    sh = wm.placement(wid)
    ids.append(None if sh is None else next(iter(sh.device_set)).id)
print(json.dumps(ids))
"""


def jax_placement(n_devices: int) -> list:
    """The device id JAX's ``WeightManager.placement`` gives each wid in
    0..7 on an ``n_devices`` host (None: the seed's device)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_PLACEMENT,
                          str(n_devices)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("n_devices", [4, 1])
def test_placement_matches_jax(n_devices):
    seed = {"w": torch.arange(4.0).reshape(2, 2)}
    want = jax_placement(n_devices)
    if n_devices == 1:
        # JAX's single-device branch: None, the seed's device
        assert want == [None] * 8
        wm = WeightManager(seed)
        assert wm.devices == [CPU]
        assert [wm.placement(wid) for wid in range(8)] == [CPU] * 8
        return
    assert want == [wid % n_devices for wid in range(8)]
    stand_ins = [torch.device("meta", i) for i in range(n_devices)]
    wm = WeightManager(seed, devices=stand_ins)
    assert [wm.placement(wid).index for wid in range(8)] == want


def test_placed_devices_rule(monkeypatch):
    """``devices=`` wins; a CUDA device without an index is every visible
    card; one with an index, or the CPU, is that device alone; the
    default never adds the CPU beside a card."""
    assert placed_devices("cpu") == [CPU]
    assert placed_devices(devices=["cpu", CPU]) == [CPU, CPU]
    with pytest.raises(ValueError, match="no device"):
        placed_devices(devices=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert placed_devices() == cards
    assert placed_devices("cuda") == cards
    assert placed_devices(torch.device("cuda")) == cards
    assert placed_devices("cuda:2") == [cards[2]]
    assert placed_devices("cpu", devices=["cuda:1", "cpu"]) == [cards[1],
                                                                 CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        placed_devices()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        placed_devices(devices=["cuda:0"])


def _wrapper_calls():
    """(name, operand whose card must be current, call) for every
    launch site of the attention, SSD and RMSNorm wrappers (CPU
    tensors: the library, the checks and the stream are faked)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    q4, k4 = r(1, 2, 16, 16), r(1, 2, 16, 16)
    q3, cache = r(1, 2, 16), r(1, 2, 32, 16)
    pages, table = r(4, 2, 8, 16), torch.zeros(1, 4, dtype=torch.int32)
    kv_len = torch.ones(1, dtype=torch.int32)
    x, dt, a, bc = r(1, 64, 2, 8), r(1, 64, 2), -r(2).abs(), r(1, 64, 16)
    xn, scale = r(2, 16), r(16)
    out = []
    for fma in (False, True):
        out.append(("flash", q4, lambda fma=fma: flash_mod.flash_attention(
            q4, k4, k4, fma=fma)))
        out.append(("ssd", x, lambda fma=fma: ssd_mod.ssd(
            x, dt, a, bc, bc, chunk=64, fma=fma)))
    for legacy in (False, True):
        out.append(("decode", q3, lambda legacy=legacy:
                    decode_mod.decode_attention(q3, cache, cache, kv_len,
                                                legacy=legacy)))
        out.append(("paged", q3, lambda legacy=legacy:
                    decode_mod.paged_decode_attention(
                        q3, pages, pages, table, kv_len, legacy=legacy)))
    out.append(("rmsnorm", xn, lambda: rmsnorm_mod.rmsnorm(xn, scale)))
    return out


@pytest.mark.parametrize("case", range(9))
def test_each_wrapper_launches_on_its_operands_card(monkeypatch, case):
    """The C entry points launch on the runtime's current device, so each
    wrapper hands ``_build.launch`` the operand whose card must be
    current (the page gather's wrapper refuses CPU tensors before it
    gets there; its call passes ``on=pages``)."""
    seen = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a, on=None, entry=None:
                        seen.append((name, on)))
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    calls = _wrapper_calls()
    assert len(calls) == 9
    name, operand, call = calls[case]
    call()
    assert len(seen) == 1 and seen[0][1] is operand, (name, seen)


# ---------------------------------------------------------------------------
# The device-list route
# ---------------------------------------------------------------------------

class _Ticks:
    """A ``perf_counter`` that advances 5 ms a call."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 0.005
        return self.t


@pytest.fixture
def steady_clock(monkeypatch):
    from repro_torch.serving import engine

    monkeypatch.setattr(engine, "time", _Ticks())


def _engine(**kw):
    return EngineConfig(**{**dict(n_slots=4, max_len=64, prefill_batch=2,
                                  page_size=8, chunk_size=16), **kw})


def _workload(n, l_out=None, seed=0):
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.05))
        reqs.append(Request(rid=i, task="chat" if i % 2 else "doc",
                            arrival=t, l_in=int(rng.integers(4, 14)),
                            l_out=l_out or int(rng.integers(2, 6)),
                            ttft_slo=5.0, tpot_slo=2.0))
    return reqs


# name -> (ClusterConfig keywords, workload)
LAYOUTS = {
    "colocated": (dict(n_workers=2, policy="rr", engine=_engine()),
                  lambda: _workload(8)),
    "pd": (dict(mode="pd", n_prefill=1, n_decode=1, policy="hyperflexis",
                engine=_engine(max_len=48)),
           lambda: _workload(8)),
    "live_migration": (dict(n_workers=2, policy="rr", live_migration=True,
                            engine=_engine(decode_block=2)),
                       lambda: _workload(6, l_out=16)),
}


def _serve(name, dtype=torch.float32, *, layout=None, **where):
    """Serve layout ``name`` (or ``layout``, a pair as in ``LAYOUTS``) on
    ``where`` (``device=`` or ``devices=``); the live-migration layout
    evacuates replica 0 once it holds a decoding request.  Returns
    (cluster, result, requests)."""
    kw, workload = layout or LAYOUTS[name]
    cfg = ClusterConfig(model=SMOKE, backend="engine", seed=0, **kw)
    c = Cluster(cfg, dtype=dtype, **where)
    reqs = workload()
    if name != "live_migration":
        return c, c.run(reqs), reqs
    c._materialize_prompts(reqs)
    s = ServingSession(c, admission="none")
    for r in reqs:
        s.submit_request(r)
    kicked = False
    for _ in range(200_000):
        kind = c.process_next()
        if kind is None:
            break
        w0 = c._by_wid[0]
        if not kicked and any(r.tokens_done >= 1 for r in w0.running):
            c._begin_evacuation(
                w0, ScaleAction("in", "collocated", 0.0, worker_id=0), c.now)
            kicked = True
        if all(r.state == RequestState.FINISHED for r in reqs) and not c._evac:
            break
    assert kicked, "replica 0 never held a decoding request"
    return c, s.close(requests=list(reqs)), reqs


def _assert_placed(c) -> None:
    """Every live replica's weights and KV pool lie on its placement."""
    for w in c.workers:
        if w.engine.model is None:
            continue
        dev = c.weights.placement(w.wid)
        assert w.engine.device == dev
        assert all(p.device == dev for p in w.engine.model.parameters())
        assert all(t.device == dev for seg in w.engine.caches
                   for t in seg.values())
        assert all(t.device == dev
                   for t in c.weights.params_of(w.wid).values())


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_device_list_serves_as_one_device(name, steady_clock):
    c1, res1, want = _serve(name, device="cpu")
    c2, res2, got = _serve(name, devices=[CPU, CPU])
    assert c1.devices == [CPU] and c2.devices == [CPU, CPU]
    assert [list(r.generated) for r in got] == [list(r.generated)
                                                 for r in want]
    assert all(len(r.generated) == r.l_out for r in got)
    assert res2.metrics.n_finished == len(got)
    assert res2.kv_transfers == res1.kv_transfers
    assert c2.tl.kv_bytes_moved == c1.tl.kv_bytes_moved
    assert res2.n_live_migrations == res1.n_live_migrations
    if name == "pd":
        assert res2.kv_transfers > 0
    if name == "live_migration":
        assert res2.n_live_migrations >= 1
    _assert_placed(c2)
    # a d2d scale-out from a live replica lands on its own placement, a
    # copy bit for bit
    wid = c2.weights.donors()[0]
    donor = c2.weights.params_of(wid)
    params, _ = c2.weights.provision(5, "d2d", donor=wid)
    assert all(t.device == c2.weights.placement(5) for t in params.values())
    assert all(torch.equal(params[k], t) for k, t in donor.items())


# ---------------------------------------------------------------------------
# Two cards
# ---------------------------------------------------------------------------

PLAIN = {"paged_decode_attention": ref.paged_decode_attention_ref,
         "page_gather": ref.page_gather_ref,
         "flash_attention": ref.flash_attention_ref,
         "decode_attention": ref.decode_attention_ref,
         "ssd": ref.ssd_ref, "rmsnorm": ref.rmsnorm_ref}


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.cuda
def test_pd_cluster_on_two_cards(two_cards, steady_clock, monkeypatch):
    """P/D with the prefill replica on card 0 and the decode replica on
    card 1, bf16 at smoke width, card 0 current throughout: the one-card
    run's tokens; every kernel call on card 1 agrees with its plain
    version (2e-2, the gather exactly); a d2d copy card to card is bit
    for bit the donor's."""
    _, _, want = _serve("pd", torch.bfloat16, devices=two_cards[:1])
    calls = []

    def keeping(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if args[0].device == two_cards[1]:
                calls.append((name, [a.clone() if torch.is_tensor(a) else a
                                     for a in args], kw, out))
            return out
        return call

    for name in PLAIN:
        monkeypatch.setattr(ops, name, keeping(name, getattr(ops, name)))
    c, res, got = _serve("pd", torch.bfloat16, devices=two_cards)
    assert res.kv_transfers > 0
    assert [list(r.generated) for r in got] == [list(r.generated)
                                                 for r in want]
    _assert_placed(c)
    assert c.weights.placement(1) == two_cards[1]
    assert {name for name, *_ in calls} >= {"paged_decode_attention"}
    for name, args, kw, out in calls:
        plain = PLAIN[name](*args, **kw)
        if name == "page_gather":
            assert torch.equal(out, plain)
        else:
            torch.testing.assert_close(out, plain, rtol=2e-2, atol=2e-2)
    donor = c.weights.params_of(0)
    params, _ = c.weights.provision(3, "d2d", donor=0)
    assert all(t.device == two_cards[1] for t in params.values())
    assert all(torch.equal(params[k], t.to(two_cards[1]))
               for k, t in donor.items())


@pytest.mark.cuda
def test_default_device_places_a_replica_on_each_card(two_cards,
                                                      steady_clock):
    """``Cluster`` with no device on a host of several cards (up to 4
    here): replica ``wid`` on ``cuda:wid``, the CPU never among the
    devices, and the tokens of the same replicas all on card 0."""
    n = min(torch.cuda.device_count(), 4)
    cards = [torch.device("cuda", i) for i in range(n)]
    layout = (dict(n_workers=n, policy="rr", engine=_engine()),
              lambda: _workload(2 * n))
    _, _, want = _serve("colocated", torch.bfloat16, layout=layout,
                        devices=cards[:1])
    c, res, got = _serve("colocated", torch.bfloat16, layout=layout)
    assert c.devices == [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    assert [c.weights.placement(wid) for wid in range(n)] == cards
    _assert_placed(c)
    assert res.metrics.n_finished == len(got)
    assert [list(r.generated) for r in got] == [list(r.generated)
                                                 for r in want]
