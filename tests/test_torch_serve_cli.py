"""The port's ``serve`` entry point against ``repro.launch.serve``.

On the sim plane both launchers print the same JSON for the same
arguments (colocated with scaling, and P/D).  On the engine plane, with
the JAX package's smoke weights in both (the port's ``Cluster`` takes
them through ``seed_params``), ``--prefix-cache --spec-decode`` over the
shared-prefix workload serves the same requests with the same prefix
and speculation counters.  ``--online`` turns the same JSONL lines into
the same stream events.  The launcher's device rule is held in
tests/test_torch_isolation.py.
"""

import functools
import io
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402


def _run(main, argv, monkeypatch, capsys, stdin=None) -> list[str]:
    """Run one launcher's ``main`` on ``argv``; its stdout lines."""
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    if main is serve.main:
        main(argv)
    else:
        main()
    return capsys.readouterr().out.splitlines()


def _both(argv, monkeypatch, capsys, port_argv=(), stdin=None):
    got = _run(serve.main, [*argv, *port_argv], monkeypatch, capsys, stdin)
    want = _run(jserve.main, argv, monkeypatch, capsys, stdin)
    return got, want


SIM = ["--backend", "sim", "--json", "--n-per-task", "6", "--qps", "16",
       "--seed", "3"]


@pytest.mark.parametrize("extra", [
    ["--scaling", "--workers", "1", "--max-workers", "3"],
    ["--mode", "pd", "--n-prefill", "1", "--n-decode", "1"],
    ["--workload", "shared-prefix", "--prefix-cache", "--spec-decode",
     "--workers", "1"],
], ids=["colocated_scaling", "pd", "prefix_spec"])
def test_sim_plane_json_equals_jax(extra, monkeypatch, capsys):
    got, want = _both(SIM + extra, monkeypatch, capsys)
    assert len(got) == 1
    assert json.loads(got[0]) == json.loads(want[0])


def test_sim_plane_text_report_equals_jax(monkeypatch, capsys):
    argv = ["--backend", "sim", "--n-per-task", "4", "--qps", "8",
            "--scaling", "--workers", "1"]
    got, want = _both(argv, monkeypatch, capsys)
    assert got == want and got[0].startswith("policy=hyperflexis")


SEED = 1   # shared-prefix arrivals at 0.02 req/s: gaps of 10 s or more


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's launcher builds its Cluster over the JAX package's
    smoke qwen7b weights for ``SEED`` — the weights JAX's Cluster draws
    — so both generate the same tokens."""
    cfg = get_smoke_config("qwen7b")
    tree = jax_build(jax_smoke("qwen7b")).init(jax.random.key(SEED))
    monkeypatch.setattr(serve, "Cluster", functools.partial(
        serve.Cluster,
        seed_params=params_from_jax(jax.tree.map(np.asarray, tree), cfg)))


# round-robin placement: no admission verdict hangs on measured times
ENGINE = ["--backend", "engine", "--model", "qwen7b", "--smoke",
          "--workers", "1", "--engine-max-len", "64", "--page-size", "8",
          "--chunk-size", "16", "--seed", str(SEED), "--policy", "rr"]


@pytest.fixture
def unfitted_profilers(monkeypatch):
    """Both packages' latency profilers stay unfitted: ``fit`` keeps
    the coefficients it has and reports no fit.  The engine-plane
    Cluster's profiler is the Dispatcher's model and every engine's
    (refitted from measured step times at each monitor tick); once
    fitted, ``slo_spec_len`` prices the speculation depth from those
    times (``slack = tpot_slo - e_d``), so on a loaded host the two
    packages could choose different depths."""
    from repro.core import latency_model as jlatency
    from repro_torch.core import latency_model as latency

    for mod in (jlatency, latency):
        monkeypatch.setattr(mod.FittedLatencyModel, "fit",
                            lambda self, min_samples=8: False)


def test_engine_plane_prefix_cache_and_spec_decode_match_jax(
        jax_weights, unfitted_profilers, monkeypatch, capsys):
    """Shared-prefix traffic at 0.02 req/s with 8 output tokens (each
    request served long before the next arrives) with the prefix cache
    and speculation at most 2 deep: the same requests served, hit
    tokens and speculation counters.  The profilers stay unfitted in
    both packages (``unfitted_profilers``), so every lane speculates at
    ``SpecConfig.unfitted_default`` (2) and neither the depth nor the
    chunk budget depends on measured step times."""
    argv = ENGINE + ["--workload", "shared-prefix", "--prefix-len", "16",
                     "--n-per-task", "2", "--qps", "0.02", "--clip-output",
                     "8", "--prefix-cache", "--spec-decode",
                     "--max-spec-len", "2", "--json"]
    got, want = _both(argv, monkeypatch, capsys,
                      port_argv=["--device", "cpu"])
    got, want = json.loads(got[0]), json.loads(want[0])
    keys = ("n_finished", "n_total", "n_rejected", "n_failed",
            "prefix_hit_tokens", "prefix_hit_rate", "spec_dispatches",
            "spec_proposed", "spec_accepted", "backend")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["n_finished"] == got["n_total"] == 8
    assert got["prefix_hit_tokens"] > 0 and got["spec_dispatches"] > 0
    assert set(got) == set(want)


def _events(lines) -> list:
    """(event kind, rid) of each stream line, and the summary's counts."""
    out = []
    for line in lines:
        ev = json.loads(line)
        if ev["event"] == "summary":
            out.append(("summary", ev["n_finished"], ev["n_total"]))
        else:
            out.append((ev["event"], ev.get("rid")))
    return out


LINES = "\n".join(json.dumps(r) for r in (
    {"task": "gsm8k", "prompt": [5, 3, 9, 2, 7], "l_out": 4, "arrival": 0.0},
    {"task": "gsm8k", "prompt": [1, 2, 3, 1, 2, 3, 1, 2], "l_out": 5,
     "arrival": 20.0},
    "not a request",
    {"task": "tldr_content_gen", "l_in": 6, "l_out": 3, "arrival": 40.0},
)) + "\n"


@pytest.mark.parametrize("plane", ["sim", "engine"])
def test_online_mode_same_event_kinds(plane, jax_weights, monkeypatch,
                                      capsys):
    """The same JSONL lines (one of them malformed) give the same
    stream events — admitted / first_token / token / finished, the
    structured error, the summary — in both launchers."""
    argv = (["--online", "--backend", "sim", "--seed", str(SEED)]
            if plane == "sim" else ["--online", "--admission", "none",
                                    *ENGINE])
    lines = LINES if plane == "sim" else LINES.replace(
        '{"task": "tldr_content_gen", "l_in": 6',
        '{"task": "tldr_content_gen", "prompt": [4, 4, 4, 4, 4, 4]')
    got, want = _both(argv, monkeypatch, capsys,
                      port_argv=["--device", "cpu"], stdin=lines)
    assert sorted(_events(got), key=str) == sorted(_events(want), key=str)
    kinds = {e[0] for e in _events(got)}
    assert {"admitted", "first_token", "finished", "error",
            "summary"} <= kinds
    if plane == "engine":
        tokens = [[json.loads(x)["token"] for x in out
                   if json.loads(x)["event"] == "token"]
                  for out in (got, want)]
        assert sorted(tokens[0]) == sorted(tokens[1])
