"""The benchmark is driven by its files: a new configuration, traffic
mix, cell or metric is a new file, found by its name; and
``BENCHMARK.json`` names only what those files provide."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from hfxbench import catalog

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "hfxbench"
    shutil.copytree(catalog.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    mix = catalog.load_json("traffic", "four_task", root)
    mix["name"] = "four_task_burst"
    (root / "traffic" / "four_task_burst.json").write_text(json.dumps(mix))
    cell = {"config": "qwen7b", "traffic": "four_task_burst",
            "judge": "tail", "rate_rps": 0.5, "drain_s": 30,
            "trace": {"start_frac": 0.8, "steps": 8},
            "check": {"sample_tokens": 300, "limit_logit_gap": 0.33}}
    (root / "cells" / "qwen7b.four_task_burst.json").write_text(
        json.dumps(cell))
    (root / "metrics" / "engine.steps.py").write_text(
        "def read(run):\n    return len(run.window_steps())\n")
    found = catalog.listing(root)
    assert set(found) == set(catalog.KINDS)
    assert "qwen1_5" in found["families"] and "qwen1_5" in found["reference"]
    assert "four_task_burst" in found["traffic"]
    assert "qwen7b.four_task_burst" in found["cells"]
    assert "engine.steps" in found["metrics"]
    c, cfg, m = catalog.resolve("qwen7b.four_task_burst", root)
    assert c["name"] == "qwen7b.four_task_burst"
    assert cfg["name"] == "qwen7b" and m["name"] == "four_task_burst"
    assert catalog.reader("engine.steps", root).__name__ == "read"
    after = _digests(root)
    assert {k: after[k] for k in before} == before   # nothing edited


def test_benchmark_json_names_what_the_files_provide():
    bench = catalog.load_benchmark(REPO)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["hfxbench"]
    assert bench["command"] == ["python3", "hfxbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    found = catalog.listing()
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["name"] in found["configs"]
        assert c["file"] == f"hfxbench/configs/{c['name']}.json"
        cfg = catalog.load_json("configs", c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert cfg["reference"] in found["reference"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for name in found["configs"]:   # those with no cell too
        cfg = catalog.load_json("configs", name)
        assert cfg["family"] in found["families"]
        assert cfg["reference"] in found["reference"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        cell, _, _ = catalog.resolve(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) == 0
    names = set()
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in names
            names.add(m["name"])
            assert m["name"] in found["metrics"]
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["per_layer"]:
        # each metric's cells report the end-to-end metric it moves
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        assert len(catalog.cell_metrics(bench, w, "end_to_end")) >= 2
        assert catalog.cell_metrics(bench, w, "per_layer")


@pytest.mark.parametrize("cfg_name", ["qwen7b", "qwen32b"])
def test_configs_are_published_widths(cfg_name):
    """Every width as published, nothing cut; the engine as every chip
    run of the port had it."""
    cfg = catalog.load_json("configs", cfg_name)
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"
    assert cfg["engine"] == {
        "n_slots": 8, "max_len": 2048, "prefill_batch": 4, "page_size": 16,
        "chunk_size": 256, "decode_block": 8, "slo_aware": True,
        "paged": True, "eos_token": None, "prefix_cache": False,
        "spec_decode": False}
    assert cfg["hidden_size"] // cfg["num_attention_heads"] == 128
