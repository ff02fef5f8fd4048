"""The port's engine examples against the JAX package's: ``quickstart``
and ``serve_engine_e2e`` (``examples/*_torch.py`` beside the JAX
scripts).

Both scripts run on the CPU at their CI arguments; the port's gets the
JAX package's smoke weights through the port's ``seeded_model``
(``jax_weights``: the weights ``build_model(cfg).init(jax.random.key(
seed))`` draws, which the JAX engine and the JAX ``Cluster`` serve
with).  The JAX scripts return
nothing, so their requests are read where the JAX engine is handed them
(``InferenceEngine.submit``) and their clusters' results where
``Cluster.run`` returns them.  What moves with host time — clocks,
fitted coefficients, TTFT, attainment on the virtual clock — is not
compared.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _examples import (  # noqa: E402,F401
    jax_weights,
    load,
    run,
    unfitted_profilers,
)
from repro.serving.cluster import Cluster as JCluster  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402


@pytest.fixture
def jax_seen(monkeypatch):
    """The requests the JAX engines are handed and the results the JAX
    clusters return, in order."""
    seen = {"submitted": [], "results": []}
    submit, cluster_run = JEngine.submit, JCluster.run

    def record_submit(self, req):
        seen["submitted"].append(req)
        return submit(self, req)

    def record_run(self, requests):
        res = cluster_run(self, requests)
        seen["results"].append(res)
        return res

    monkeypatch.setattr(JEngine, "submit", record_submit)
    monkeypatch.setattr(JCluster, "run", record_run)
    return seen


def tokens(reqs) -> dict:
    return {r.rid: [int(t) for t in r.generated or []] for r in reqs}


def line(lines, prefix) -> str:
    (hit,) = [s for s in lines if s.startswith(prefix)]
    return hit


def test_quickstart_matches_jax(jax_seen, jax_weights, unfitted_profilers,
                                monkeypatch, capsys):
    """Stage 1's 8 requests generate the same tokens; stage 3's
    ``cluster[sim]:`` line is equal character for character; stage 4's
    engine-backed cluster serves 10/10 in both, every request with the
    same tokens.  The profilers stay unfitted (``unfitted_profilers``):
    stage 4's Dispatcher budgets with them (stage 2's printed fit, which
    moves with the host, is not compared)."""
    got, lines = run(load("quickstart_torch"), ["--device", "cpu"],
                     monkeypatch, capsys)
    _, want = run(load("quickstart"), [], monkeypatch, capsys)

    stage1 = jax_seen["submitted"][:8]
    assert [r.rid for r in stage1] == list(range(8))
    assert got["tokens"] == tokens(stage1)
    assert all(len(t) == 8 for t in got["tokens"].values())
    assert (line(lines, "  first generation:")
            == line(want, "  first generation:"))
    assert line(lines, "cluster[sim]:") == line(want, "cluster[sim]:")

    engine_res = jax_seen["results"][-1]
    assert line(lines, "cluster[engine]:").startswith(
        "cluster[engine]: served 10/10 ")
    assert line(want, "cluster[engine]:").startswith(
        "cluster[engine]: served 10/10 ")
    assert got["cluster_served"] == got["cluster_total"] == 10
    assert got["cluster_tokens"] == tokens(engine_res.requests)
    assert all(got["cluster_tokens"].values())
    assert got["served"] == got["total"] == 18


@pytest.mark.parametrize("arch,n", [("qwen7b", 12), ("gemma3-4b", 8),
                                    ("mamba2-2.7b", 8)])
def test_serve_engine_e2e_matches_jax(arch, n, jax_seen, jax_weights,
                                      monkeypatch, capsys):
    """``--arch ARCH --n-requests N --slots 4`` (qwen7b at the CI's
    arguments; gemma3-4b runs the slot plane, mamba2-2.7b the paged plane
    with its SSM state in slot rows): both serve every request, each
    with the same tokens."""
    argv = ["--arch", arch, "--n-requests", str(n), "--slots", "4"]
    got, lines = run(load("serve_engine_e2e_torch"),
                     [*argv, "--device", "cpu"], monkeypatch, capsys)
    _, want = run(load("serve_engine_e2e"), argv, monkeypatch, capsys)
    served = f"served {n}/{n} in "
    assert line(lines, "served ").startswith(served)
    assert line(want, "served ").startswith(served)
    assert got["served"] == got["total"] == n
    assert got["paged"] == (arch != "gemma3-4b")
    assert got["tokens"] == tokens(jax_seen["submitted"])
    assert all(got["tokens"].values())
