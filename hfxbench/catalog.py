"""Find the benchmark's parts by name.

Everything that belongs to one configuration, traffic mix, cell,
metric or reference family is a file of its own under this folder,
found from the name alone:

- ``configs/<config>.json``: a model's published sizes, the engine
  settings it is served with, its family, its reference family and what
  was assumed;
- ``families/<family>.py``: how the benchmark draws, builds and counts
  one architecture family: ``shapes(cfg)`` (every weight's shape, in
  the order drawn), ``std(name, shape)``, ``port_config(cfg)`` (the
  port's ``ModelConfig``), ``state_dict(cfg, weights)`` (the port's
  parameter names mapped to views of the drawn tensors) and
  ``counts(cfg)`` (the FLOPs and bytes the metric readers take);
- ``traffic/<mix>.json``: the parameters the one traffic generator reads;
- ``cells/<cell>.json``: the configuration, the mix, the rate and the
  run's shape (pre-roll, drain, traced steps, the correctness limit);
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``;
- ``reference/<family>.py``: a plain PyTorch forward of one family.

A configuration of a new architecture is its config file, its family
and its reference, with a cell and a mix as for any other.

A counter that only the program knows (say, the experts a step's
routing touched) reaches a metric file as an attribute of its step's
``engine.dispatch`` span: the program's code adds it there
(``InferenceEngine._timed``'s attributes), and a traced run hands each
step those attributes as ``Step.dispatch`` (``spans.py``).  The metric
file reads them from the run's steps, next to the kernels' device time
in ``run.trace["kernels"]``; in an untraced run, or where the spans and
the steps do not pair, ``Step.dispatch`` is None and it returns None.

Adding one of them is adding a file: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable

ROOT = Path(__file__).resolve().parent
KINDS = {"configs": ".json", "traffic": ".json", "cells": ".json",
         "metrics": ".py", "families": ".py", "reference": ".py"}


def _path(kind: str, name: str, root: Path) -> Path:
    if "/" in name or name.startswith("."):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / kind / f"{name}{KINDS[kind]}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r} at {path}")
    return path


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    with open(_path(kind, name, root)) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """A metric reader, a family or a reference, loaded from its file (a
    metric's name may hold dots, so it is not imported as a module).  It
    is entered in ``sys.modules`` under its own name before its code
    runs, as ``dataclasses`` needs."""
    path = _path(kind, name, root)
    spec = importlib.util.spec_from_file_location(
        f"hfxbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT) -> Callable:
    return load_module("metrics", metric, root).read


def listing(root: Path = ROOT) -> dict[str, list[str]]:
    """Every name of every kind that has a file under ``root``."""
    out = {}
    for kind, suffix in KINDS.items():
        out[kind] = sorted(p.name[:-len(suffix)]
                           for p in (root / kind).glob(f"*{suffix}")
                           if not p.name.startswith("_"))
    return out


def load_benchmark(repo: Path = ROOT.parent) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def cell_metrics(bench: dict, name: str, group: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics cell ``name`` reports:
    those whose ``workloads`` list it, and those with no such list."""
    return [m for m in bench[group]
            if name in m.get("workloads", [name])]


def resolve(cell_name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, config, traffic) of a cell, by its name."""
    cell = {**load_json("cells", cell_name, root), "name": cell_name}
    return (cell, load_json("configs", cell["config"], root),
            load_json("traffic", cell["traffic"], root))
