"""Nothing the benchmark runs loads JAX or the JAX package.

Checked in a fresh interpreter (a test worker may have loaded JAX for
other tests): it imports the command's modules, the reference and the
program, and every top-level module name is compared whole, so the
port (``repro_torch``) passes and ``repro`` does not."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

PROBE = """
import importlib.util, json, sys
sys.path[:0] = [{root!r}, {src!r}]
spec = importlib.util.spec_from_file_location("run", {run!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from hfxbench import calibrate, catalog, check, harness, sweep
import repro_torch.serving.engine, repro_torch.models.build
for kind in ("metrics", "families", "reference"):
    for name in catalog.listing()[kind]:
        catalog.load_module(kind, name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_loads_jax_or_the_jax_package():
    code = PROBE.format(root=str(REPO), src=str(REPO / "src"),
                        run=str(REPO / "hfxbench" / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "hfxbench" in top
    assert not top & FORBIDDEN


def test_the_check_names_whole_top_level_modules():
    from hfxbench import harness

    assert harness.FORBIDDEN == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN
