"""Fixtures of the benchmark's CPU tests: the benchmark's own cells and
files, cut to a smoke width that the CPU serves in seconds.  Nothing here
asks whether a card is present; a test that needs one is marked
``cuda`` and decides inside itself."""

import copy

import pytest

from hfxbench import catalog


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel; skips without a CUDA card")


def smoke_config(dtype: str = "float32") -> dict:
    """qwen7b's file at a smoke width: 2 layers, d 64, 4 heads of 16
    over 2 K/V heads (GQA), vocabulary 256, a small engine."""
    cfg = catalog.load_json("configs", "qwen7b")
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
               dtype=dtype)
    cfg["engine"].update(n_slots=4, max_len=64, prefill_batch=2,
                         page_size=8, chunk_size=16)
    return cfg


def smoke_mix(name: str = "four_task") -> dict:
    """A mix's tasks, SLOs and shares, with lengths cut to fit 64
    positions."""
    mix = catalog.load_json("traffic", name)
    mix.update(max_prompt=40, max_total=63)
    for t in mix["tasks"]:
        for key, cut in (("input", 16), ("output", 8)):
            t[key] = {"mean": t[key]["mean"] / cut, "std": t[key]["std"] / cut}
    return mix


def smoke_cell(name: str = "qwen7b.four_task") -> dict:
    cell, _, _ = catalog.resolve(name)
    cell = copy.deepcopy(cell)
    # a long drain: on a loaded host every request still finishes (the
    # loop stops as soon as they have)
    cell.update(rate_rps=20.0, drain_s=600.0, preroll_s=0.0)
    cell["trace"] = {"start_frac": 0.6, "steps": 8}
    # f32 against the f32 reference: rounding alone, far under this
    cell["check"]["limit_logit_gap"] = 1e-3
    return cell


@pytest.fixture
def smoke():
    return {"cell": smoke_cell(), "config": smoke_config(),
            "mix": smoke_mix(), "bench": catalog.load_benchmark()}
