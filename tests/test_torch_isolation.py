"""The PyTorch port stands alone: no module of ``src/repro_torch/`` and
not ``chip_smoke.py`` imports JAX or the JAX package ``repro``, and its
entry points refuse to drop quietly to the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.checkpoint import (  # noqa: E402
    load_checkpoint,
    load_latest,
    save_checkpoint,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
