"""A run of the harness on the CPU at the smoke width: correct when the
program is sound, not correct when the timed path is broken underneath,
and no result at all without a card or without the program."""

import io
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from hfxbench import catalog, harness

REPO = Path(__file__).resolve().parents[2]


def _run(smoke, trace=False, seed=2 ** 31 + 3):
    return harness.run_cell(smoke["cell"], smoke["config"], smoke["mix"],
                            seed=seed, seconds=1.5, trace=trace,
                            device="cpu", t_start=time.perf_counter(),
                            bench=smoke["bench"], log=io.StringIO())


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(smoke, trace):
    res = _run(smoke, trace)
    assert res["correct"] is True
    assert res["attempted"] == 30 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert res["compared"]["logit_gap_max"]["value"] <= 1e-3
    assert res["compared"]["stream_mismatches"]["value"] == 0
    want = {m["name"] for m in catalog.cell_metrics(
        smoke["bench"], "qwen7b.four_task",
        "per_layer" if trace else "end_to_end")}
    got = set(res["metrics"])
    if trace:
        # no device on the CPU: the trace's readers find nothing; the
        # steps' readers read the window before the profiled steps
        assert got <= want - {"paged_decode_attention_roofline.tail",
                              "device.idle_share.tail"}
        assert {"engine.prefill_tokens_per_step", "step.prefill_ms",
                "mfu.prefill"} <= got
        assert res["device"]["busy_s"] == 0.0
    else:
        assert got == want
    for m in res["metrics"].values():
        assert m["value"] >= 0 and m["unit"]


def _no_kv_writes(monkeypatch):
    """A step that returns its state unchanged: no K/V reaches the pool."""
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "update_paged_cache",
                        lambda *a, **k: None)


def _half_the_batch(monkeypatch):
    """Half of the batch left out: the odd rows of every step frozen."""
    from repro_torch.models.build import Model

    real = Model.chunk_step

    def chunk_step(self, caches, table, tokens, start, lens):
        lens = lens.clone()
        lens[1::2] = 0
        return real(self, caches, table, tokens, start, lens)

    monkeypatch.setattr(Model, "chunk_step", chunk_step)


def _token_altered(monkeypatch):
    """A token altered where it is produced: the greedy pick of every
    step takes the next vocabulary id."""
    from repro_torch.models.build import Model

    real = Model.chunk_step

    def chunk_step(self, *args):
        logits, caches = real(self, *args)
        return logits.roll(1, dims=-1), caches

    monkeypatch.setattr(Model, "chunk_step", chunk_step)


# the exchange between chips is a fault a one-card cell cannot have
@pytest.mark.parametrize("fault", [_no_kv_writes, _half_the_batch,
                                   _token_altered])
def test_broken_timed_path_is_not_correct(smoke, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(smoke)
    assert res["correct"] is False
    assert res["compared"]["logit_gap_max"]["value"] > 1e-3


def test_forbidden_modules_are_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert "repro" in harness.forbidden_modules()


def _command(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "hfxbench/run.py", "--workload", "qwen7b.four_task",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    """Without a CUDA card the command fails and prints no result: it
    never falls back to the CPU."""
    out = _command(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's
    files: no program to run, no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "hfxbench", tmp_path / "hfxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr


@pytest.mark.cuda
def test_smoke_run_on_the_card(smoke):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    smoke["config"]["dtype"] = "float32"
    res = harness.run_cell(smoke["cell"], smoke["config"], smoke["mix"],
                           seed=11, seconds=1.5, trace=True, device="cuda:0",
                           t_start=time.perf_counter(), bench=smoke["bench"],
                           log=io.StringIO())
    assert res["correct"] is True and res["device"]["busy_s"] > 0
    json.dumps(res, allow_nan=False)
