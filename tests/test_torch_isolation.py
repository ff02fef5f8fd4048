"""The PyTorch port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and no port example (``examples/*_torch.py``) imports
JAX or the JAX package ``repro``, and its entry points refuse to drop
quietly to the CPU."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.latency_model import FittedLatencyModel  # noqa: E402
from repro_torch.distributed.checkpoint import (  # noqa: E402
    load_checkpoint,
    load_latest,
    save_checkpoint,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402

from _examples import load, run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", *EXAMPLES]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_nothing_of_repro(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_import_rule():
    assert _forbidden("jax.numpy") and _forbidden("repro.kernels.ref")
    assert _forbidden("repro") and not _forbidden("repro_torch.models")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg, device="cuda")
    assert Model(cfg, device="cpu").device.type == "cpu"
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    save_checkpoint(str(tmp_path), 0, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint(str(tmp_path), 0, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_latest(str(tmp_path), tree)
    got, _ = load_checkpoint(str(tmp_path), 0, tree, device="cpu")
    assert got["w"].device.type == "cpu" and torch.equal(got["w"], tree["w"])
    # the serve launcher's engine plane: CUDA unless --device names another
    argv = ["--backend", "engine", "--smoke", "--workers", "1",
            "--n-per-task", "1", "--engine-max-len", "48",
            "--clip-prompt", "8", "--clip-output", "2", "--json"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([*argv, "--device", "cuda"])


def test_every_example_has_a_port_counterpart():
    jax_examples = {p.stem for p in (ROOT / "examples").glob("*.py")
                    if not p.stem.endswith("_torch")}
    assert {p.stem.removesuffix("_torch") for p in EXAMPLES} == jax_examples
    assert len(EXAMPLES) == 5


# each port example's run that builds an engine or a model, at its least
DEVICE_RUNS = {
    "quickstart_torch": [],
    "serve_engine_e2e_torch": ["--n-requests", "2"],
    "pd_disaggregated_torch": ["--backend", "engine", "--smoke"],
    "online_serving_torch": ["--smoke", "--clients", "1", "--rounds", "1"],
    "train_small_torch": ["--steps", "2", "--batch", "2", "--seq", "8"],
}


@pytest.mark.parametrize("name", sorted(DEVICE_RUNS))
def test_example_defaults_to_cuda_and_raises_without_it(
        name, monkeypatch, capsys, tmp_path):
    """Without ``--device`` (or with ``--device cuda``) an example's
    engine or model path raises the ``resolve_device`` error on a host
    with no card; with ``--device cpu`` it runs.  ``train_small`` runs a
    narrowed ``SMALL`` here.  The latency profiler stays unfitted, so no
    placement or admission reads this host's speed (see
    ``tests/_examples.py::unfitted_profilers``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(FittedLatencyModel, "fit",
                        lambda self, min_samples=8: False)
    mod = load(name)
    argv = list(DEVICE_RUNS[name])
    if name == "train_small_torch":
        monkeypatch.setattr(mod, "SMALL", dataclasses.replace(
            mod.SMALL, n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
            d_ff=64, vocab_size=64))
        argv += ["--ckpt-dir", str(tmp_path)]
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(mod, [*argv, *device], monkeypatch, capsys)
    out, lines = run(mod, [*argv, "--device", "cpu"], monkeypatch, capsys)
    assert lines
    if name == "train_small_torch":
        assert out["steps_run"] == 2 and np.isfinite(out["final_loss"])
    else:
        assert out["served"] == out["total"] > 0


@pytest.mark.parametrize("name,argv", [
    ("pd_disaggregated_torch", ["--smoke"]),
    ("online_serving_torch", []),
    ("online_serving_torch", ["--backend", "sim", "--clients", "2"]),
], ids=["pd_sim", "online_sim", "online_sim_backend"])
def test_sim_only_example_paths_need_no_card(name, argv, monkeypatch,
                                             capsys):
    """The sim plane reads no device: with no card and no ``--device``
    these runs serve."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, lines = run(load(name), argv, monkeypatch, capsys)
    assert lines and out["served"] > 0
    assert out["served"] + out.get("rejected", 0) == out["total"]
