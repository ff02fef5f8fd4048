"""Helpers of the ``tests/test_torch_examples_*.py`` files: load a script
of ``examples/`` (not a package) by path, run its ``main`` as the command
line would, hand the port's examples the JAX package's smoke weights,
and keep both packages' latency profilers off host-measured step
times."""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def load(name: str):
    """The module of ``examples/<name>.py``, freshly executed."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(mod, argv, monkeypatch, capsys):
    """``python examples/<mod>.py *argv``: (what ``main`` returned, the
    lines it printed)."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    out = mod.main()
    return out, capsys.readouterr().out.splitlines()


@functools.lru_cache(maxsize=None)
def _jax_state(arch: str, seed: int) -> dict:
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import build_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import params_from_jax

    tree = build_model(jax_smoke(arch)).init(jax.random.key(seed))
    return params_from_jax(jax.tree.map(np.asarray, tree),
                           get_smoke_config(arch))


def jax_seeded_model(cfg, device=None, seed: int = 0, *,
                     dtype=torch.float32):
    """Drop-in for the port's ``models.build.seeded_model``: ``cfg``'s
    model holding the weights the JAX package's
    ``build_model(cfg).init(jax.random.key(seed))`` draws for the smoke
    config ``cfg`` (what JAX's examples and its engine ``Cluster`` serve
    with)."""
    from repro_torch.models.build import Model

    model = Model(cfg, dtype=dtype, device=device)
    model.load_state_dict(_jax_state(cfg.name.removesuffix("-smoke"), seed))
    return model


@pytest.fixture
def jax_weights(monkeypatch):
    """Every model the port's examples seed — their engines' and their
    engine-plane ``Cluster``s' — holds the JAX package's weights."""
    from repro_torch.models import build

    monkeypatch.setattr(build, "seeded_model", jax_seeded_model)


@pytest.fixture
def unfitted_profilers(monkeypatch):
    """Both packages' latency profilers keep the coefficients they start
    with (``fit`` reports no fit), as ``test_torch_serve_cli.py`` does.
    An engine-plane ``Cluster`` refits its Dispatcher's and Migrator's
    model from host-measured step times; on a loaded host a fitted
    decode time above a request's TPOT budget leaves prefilled requests
    parked (the Migrator places a request only where ``E_d`` fits the
    budget) and ``admission="reject"`` rejects, so the packages could
    serve different sets.  Unfitted, no placement reads the host's
    speed."""
    from repro.core import latency_model as jlatency
    from repro_torch.core import latency_model as latency

    for mod in (jlatency, latency):
        monkeypatch.setattr(mod.FittedLatencyModel, "fit",
                            lambda self, min_samples=8: False)
