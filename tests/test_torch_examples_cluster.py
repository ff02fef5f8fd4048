"""The port's cluster and session examples against the JAX package's:
``pd_disaggregated`` and ``online_serving`` (``examples/*_torch.py``
beside the JAX scripts).

On the sim plane the two scripts print the same lines.  On the engine
plane the port's ``Cluster`` gets the JAX package's smoke weights
through the port's ``seeded_model`` (``jax_weights``: the tree the JAX
``Cluster`` draws from ``jax.random.key(cfg.seed)``); the JAX scripts
return nothing, so their requests are read from the result the JAX
``Cluster.run`` returns and their stream events from the handles the
JAX ``ServingSession.submit`` hands out.  What moves with host time — TTFT, e2e, TTFB, ITL — is not
compared.
"""

import re

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _examples import (  # noqa: E402,F401
    jax_weights,
    load,
    run,
    unfitted_profilers,
)
from repro.serving import session as jsession  # noqa: E402
from repro.serving.cluster import Cluster as JCluster  # noqa: E402
from repro_torch.serving import session as session  # noqa: E402


def tokens(reqs) -> dict:
    return {r.rid: [int(t) for t in r.generated or []] for r in reqs}


def test_pd_disaggregated_sim_prints_jax_lines(monkeypatch, capsys):
    """``--smoke`` on the sim plane (the four runs: one-shot RR-PD,
    HyperFlexis-PD, with D2D and with disk scaling): every printed line
    is equal."""
    got, lines = run(load("pd_disaggregated_torch"), ["--smoke"],
                     monkeypatch, capsys)
    _, want = run(load("pd_disaggregated"), ["--smoke"], monkeypatch, capsys)
    assert lines == want
    assert sum(s.startswith("== ") for s in lines) == 4
    assert got["served"] == got["total"] > 0


def test_pd_disaggregated_engine_matches_jax(jax_weights, unfitted_profilers,
                                             monkeypatch, capsys):
    """``--backend engine --smoke``: ``finished=8/8 kv_transfers=8
    kv_bytes=183296`` in both, every request with the same tokens, and
    the same requests decoded off their prefill worker.  The profilers
    stay unfitted (``unfitted_profilers``): fitted from a loaded host's
    step times, the Migrator can find no decode worker within the
    TPOT budget and leave requests parked (ROADMAP §3)."""
    results = []
    cluster_run = JCluster.run

    def record_run(self, requests):
        results.append(cluster_run(self, requests))
        return results[-1]

    monkeypatch.setattr(JCluster, "run", record_run)
    argv = ["--backend", "engine", "--smoke"]
    got, lines = run(load("pd_disaggregated_torch"),
                     [*argv, "--device", "cpu"], monkeypatch, capsys)
    _, want = run(load("pd_disaggregated"), argv, monkeypatch, capsys)
    summary = ("engine-pd                    finished=8/8 kv_transfers=8 "
               "kv_bytes=183296")
    assert lines[1] == want[1] == summary
    assert (got["served"], got["total"], got["kv_transfers"],
            got["kv_bytes"]) == (8, 8, 8, 183296)
    (res,) = results
    assert got["tokens"] == tokens(res.requests)
    assert all(got["tokens"].values())
    assert got["moved"] == sorted(
        r.rid for r in res.requests if r.decode_worker is not None
        and r.decode_worker != r.prefill_worker)
    assert lines[2] == want[2]


@pytest.fixture
def handles(monkeypatch):
    """Every ``ServingSession``'s handles and closing result, per
    package, in submission order."""
    seen = {"jax": ([], []), "port": ([], [])}
    for key, mod in (("jax", jsession), ("port", session)):
        submit, close = mod.ServingSession.submit, mod.ServingSession.close
        hs, results = seen[key]

        def record_submit(self, *a, _submit=submit, _hs=hs, **kw):
            _hs.append(_submit(self, *a, **kw))
            return _hs[-1]

        def record_close(self, *a, _close=close, _res=results, **kw):
            _res.append(_close(self, *a, **kw))
            return _res[-1]

        monkeypatch.setattr(mod.ServingSession, "submit", record_submit)
        monkeypatch.setattr(mod.ServingSession, "close", record_close)
    return seen


CLIENT = re.compile(r"client (\d+): (\S+)\s+(\d+) tokens ")


def test_online_serving_smoke_matches_jax(handles, jax_weights,
                                          unfitted_profilers, monkeypatch,
                                          capsys):
    """``--smoke`` (the engine plane, 2 clients x 2 rounds): the same
    clients, tasks and token counts in the same order, ``finished 4/4
    rejected 0``, the same event kinds on each handle and the same
    tokens for every request.  The profilers stay unfitted
    (``unfitted_profilers``): admission ``reject`` reads them."""
    got, lines = run(load("online_serving_torch"),
                     ["--smoke", "--device", "cpu"], monkeypatch, capsys)
    _, want = run(load("online_serving"), ["--smoke"], monkeypatch, capsys)
    rounds = [(int(c), t, int(n)) for c, t, n in
              (CLIENT.match(s).groups() for s in lines if CLIENT.match(s))]
    want_rounds = [(int(c), t, int(n)) for c, t, n in
                   (CLIENT.match(s).groups() for s in want
                    if CLIENT.match(s))]
    assert rounds == want_rounds == [tuple(r) for r in got["rounds"]]
    assert [n for _, _, n in rounds] == [4, 3, 2, 2]
    # attainment reads TTFT on a clock of host-measured step times
    counts = re.compile(r"  attainment \S+  finished 4/4  rejected 0$")
    assert any(counts.match(s) for s in lines)
    assert any(counts.match(s) for s in want)
    assert (got["served"], got["total"], got["rejected"]) == (4, 4, 0)

    (jhs, (jres,)), (phs, _) = handles["jax"], handles["port"]
    assert ([[e.kind.value for e in h.log] for h in phs]
            == [[e.kind.value for e in h.log] for h in jhs])
    assert got["tokens"] == tokens(jres.requests)
    assert all(got["tokens"].values())


def test_online_serving_sim_prints_jax_lines(monkeypatch, capsys):
    """The default run (sim plane, 4 clients x 3 rounds, admission
    ``reject``): every printed line is equal."""
    got, lines = run(load("online_serving_torch"), [], monkeypatch, capsys)
    _, want = run(load("online_serving"), [], monkeypatch, capsys)
    assert lines == want
    assert got["served"] + got["rejected"] == got["total"] == 12
