"""The port's online ``ServingSession`` over the engine-plane ``Cluster``
against the JAX package's (ports of the engine cases of
``tests/test_online_session.py``): streamed tokens identical to the
batch run and to the JAX Cluster's, event order and monotonic stamps, a
submit while another request streams, and an impossible request turned
into a REJECTED verdict.

Both clusters serve the smoke qwen7b with the JAX package's weights for
seed 0 (the port's through ``convert.params_from_jax``), in f32 on the
CPU.  Tokens do not hang on the schedule (greedy decode; each request's
prompt is materialized from the seed), so they are compared across
packages although both clocks are measured wall time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import session as jsession  # noqa: E402
from repro.serving.cluster import Cluster as JCluster  # noqa: E402
from repro.serving.cluster import ClusterConfig as JClusterConfig  # noqa
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.cluster import Cluster, ClusterConfig  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.session import (  # noqa: E402
    EventKind,
    ServingSession,
)

SMOKE = get_smoke_config("qwen7b")
TOKEN_KINDS = (EventKind.FIRST_TOKEN, EventKind.TOKEN)


@pytest.fixture(scope="module")
def seed_params():
    """The JAX package's smoke qwen7b weights for seed 0 — what its
    engine-plane Cluster draws — in the port's names."""
    tree = jax_build(jax_smoke("qwen7b")).init(jax.random.key(0))
    return params_from_jax(jax.tree.map(np.asarray, tree), SMOKE)


def _engine_cfg(CC=ClusterConfig, EC=EngineConfig, smoke=SMOKE):
    return CC(model=smoke, backend="engine", n_workers=1,
              policy="hyperflexis", seed=0,
              engine=EC(n_slots=4, max_len=48, prefill_batch=2,
                        page_size=8, chunk_size=16))


def _cluster(seed_params):
    return Cluster(_engine_cfg(), device="cpu", seed_params=seed_params)


def _jax_cluster():
    return JCluster(_engine_cfg(JClusterConfig, JEngineConfig,
                                jax_smoke("qwen7b")))


def _workload(make=Request, n=8, seed=3):
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.05))
        reqs.append(make(rid=i, task="gsm8k", arrival=t,
                         l_in=int(rng.integers(4, 14)),
                         l_out=int(rng.integers(2, 6)),
                         ttft_slo=5.0, tpot_slo=1.0))
    return reqs


def _streamed_tokens(handle, kinds=TOKEN_KINDS):
    return [ev.token for ev in handle.log if ev.kind in kinds]


def test_online_stream_token_identical_to_batch_engine(seed_params):
    """Online ``submit``-streamed token ids equal the batch
    ``Cluster.run`` output on the engine plane, and the JAX Cluster's
    batch run."""
    batch_reqs = _workload()
    _cluster(seed_params).run(batch_reqs)
    jreqs = _workload(JRequest)
    _jax_cluster().run(jreqs)

    session = ServingSession(_cluster(seed_params), admission="none")
    handles = [session.submit_request(r) for r in _workload()]
    session.drain()
    session.close()

    for h, br, jr in zip(handles, batch_reqs, jreqs):
        assert h.done and not h.rejected
        streamed = _streamed_tokens(h)
        assert streamed == h.request.generated      # stream == record
        assert streamed == br.generated             # online == batch
        assert streamed == list(jr.generated)       # port == JAX
        assert len(streamed) == h.request.tokens_done


def test_event_ordering_and_timestamp_monotonicity(seed_params):
    session = ServingSession(_cluster(seed_params), admission="none")
    handles = [session.submit_request(r) for r in _workload(n=6)]
    session.drain()
    session.close()
    for h in handles:
        kinds = [ev.kind for ev in h.log]
        assert kinds[0] == EventKind.ADMITTED
        assert kinds[1] == EventKind.FIRST_TOKEN
        assert kinds[-1] == EventKind.FINISHED
        assert all(k == EventKind.TOKEN for k in kinds[2:-1])
        times = [ev.time for ev in h.log]
        assert all(b >= a - 1e-12 for a, b in zip(times, times[1:]))
        assert h.log[1].time == pytest.approx(h.request.first_token_time)
        assert h.log[-1].data["n_tokens"] == h.request.tokens_done


def test_submit_after_start_mid_run(seed_params):
    """A request submitted while the loop streams another one is
    admitted after that one's first token and served — in both
    packages, with the same tokens."""
    out = []
    for session, kinds in (
        (ServingSession(_cluster(seed_params), admission="none"),
         TOKEN_KINDS),
        (jsession.ServingSession(_jax_cluster(), admission="none"),
         (jsession.EventKind.FIRST_TOKEN, jsession.EventKind.TOKEN)),
    ):
        h1 = session.submit(prompt=np.arange(1, 9, dtype=np.int32),
                            l_out=5, ttft_slo=5.0, tpot_slo=1.0)
        it = h1.events()
        while next(it).kind != kinds[0]:
            pass  # h1 is mid-stream now
        h2 = session.submit(prompt=np.arange(3, 9, dtype=np.int32),
                            l_out=3, ttft_slo=5.0, tpot_slo=1.0)
        assert h2.request.arrival >= h1.request.first_token_time
        session.drain()
        session.close()
        assert h1.done and h2.done
        assert _streamed_tokens(h1, kinds) == list(h1.request.generated)
        assert _streamed_tokens(h2, kinds) == list(h2.request.generated)
        assert len(h2.request.generated) == 3
        out.append([list(h.request.generated) for h in (h1, h2)])
    assert out[0] == out[1]


def test_engine_impossible_request_rejected_not_raised(seed_params):
    """Online mode turns the engine's validation error into a REJECTED
    verdict instead of an exception, with the JAX session's reason."""
    reasons = []
    for session in (ServingSession(_cluster(seed_params),
                                   admission="reject"),
                    jsession.ServingSession(_jax_cluster(),
                                            admission="reject")):
        h = session.submit(l_in=4096, l_out=4, ttft_slo=10.0, tpot_slo=1.0)
        assert h.rejected
        reasons.append(h.log[-1].data["reason"])
        session.drain()
        session.close()
    assert "never fit" in reasons[0] and reasons[0] == reasons[1]
