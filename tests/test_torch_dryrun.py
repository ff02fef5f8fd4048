"""The port's meta-device dry run, roofline report and hillclimb.

- ``memory.argument_bytes`` per device equals XLA's
  ``memory_analysis().argument_size_in_bytes`` of JAX's ``build_cell``
  exactly, for qwen7b, olmoe-1b-7b and mamba2-2.7b at smoke width (train
  8 x 64, prefill 8 x 64, decode 8 over 128) on a 4 x 4 mesh and for
  qwen7b train on (pod 2, data 2, model 4).  JAX runs in a subprocess
  with 16 host devices and a mesh of ``AxisType.Auto`` axes (its
  ``make_production_mesh`` builds Explicit axes under jax 0.9, on which
  every cell fails); its ``cost_analysis`` FLOPs are printed beside the
  port's (``-s``), not compared: XLA counts elementwise work too;
- the meta-device FLOP count of those nine cells equals
  FlopCounterMode's count of the same step run on the CPU;
- the collective parser and the roofline's baseline detection
  (tests/test_migrator_and_infra.py's tests, on the port's modules);
- every production (arch, shape, mesh) cell builds with status ok on
  meta (bytes, plans, collectives; FLOPs counted for five cells: the
  CLI's two and a hillclimb's three), ``parse_variant``'s knobs, the
  compressed multi-pod plan.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, roofline  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen7b", "olmoe-1b-7b", "mamba2-2.7b")
SHAPES = {"train": ShapeSpec("train_smoke", 64, 8, "train"),
          "prefill": ShapeSpec("prefill_smoke", 64, 8, "prefill"),
          "decode": ShapeSpec("decode_smoke", 128, 8, "decode")}
MESH = MeshSpec(("data", "model"), (4, 4))
POD_MESH = MeshSpec(("pod", "data", "model"), (2, 2, 4))

_JAX_CELLS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax
jax.devices()          # the device count is fixed from here on
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.launch.dryrun import build_cell, parse_collectives
shapes = {k: ShapeSpec(*v) for k, v in %(shapes)r.items()}
auto = lambda n: (AxisType.Auto,) * n
meshes = {"4x4": jax.make_mesh((4, 4), ("data", "model"),
                               axis_types=auto(2)),
          "2x2x4": jax.make_mesh((2, 2, 4), ("pod", "data", "model"),
                                 axis_types=auto(3))}
cells = [(a, k, "4x4") for a in %(archs)r for k in shapes]
cells.append(("qwen7b", "train", "2x2x4"))
out = {}
for arch, kind, mk in cells:
    compiled = build_cell(get_smoke_config(arch), shapes[kind], meshes[mk],
                          unroll=True)().compile()
    out[f"{arch}|{kind}|{mk}"] = {
        "argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
        "flops": compiled.cost_analysis().get("flops", 0.0),
        "link_bytes": parse_collectives(compiled.as_text())["link_bytes"]}
print(json.dumps(out))
""" % {"shapes": {k: (s.name, s.seq_len, s.global_batch, s.kind)
                  for k, s in SHAPES.items()}, "archs": ARCHS}


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_CELLS], env=env,
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-1500:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_argument_bytes_equal_xla(jax_cells):
    rows = []
    for arch in ARCHS:
        for kind, shape in SHAPES.items():
            rec = dryrun.measure_cell(get_smoke_config(arch), shape, MESH)
            want = jax_cells[f"{arch}|{kind}|4x4"]
            rows.append((arch, kind, rec["memory"]["argument_bytes"],
                         want["argument_bytes"], rec["flops_per_device"],
                         want["flops"], rec["collective_bytes_per_device"],
                         want["link_bytes"]))
    rec = dryrun.measure_cell(get_smoke_config("qwen7b"), SHAPES["train"],
                              POD_MESH, flops=False)
    want = jax_cells["qwen7b|train|2x2x4"]
    rows.append(("qwen7b", "train (pod 2, data 2, model 4)",
                 rec["memory"]["argument_bytes"], want["argument_bytes"],
                 None, want["flops"], rec["collective_bytes_per_device"],
                 want["link_bytes"]))
    print("\narch | cell | port argument bytes | XLA | port FLOPs/device"
          " | XLA cost_analysis FLOPs | port link bytes | XLA's parsed")
    for row in rows:
        print(" | ".join(map(str, row)))
    assert [r[2] for r in rows] == [r[3] for r in rows]
    assert rows[0][2] == 92_040 and rows[7][2] == 12_600


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_flops_equal_a_cpu_run(arch):
    cfg = get_smoke_config(arch)
    for kind, shape in SHAPES.items():
        meta = dryrun.count_flops(dryrun.build_cell(cfg, shape, MESH))
        cpu = dryrun.count_flops(dryrun.build_cell(cfg, shape, MESH,
                                                   device="cpu"))
        assert meta == cpu > 0, (kind, meta, cpu)


def test_a_cell_on_cpu_allocates_its_argument_bytes():
    """On a (data 1, model 1) mesh every argument is whole: the bytes of
    the tensors a real cell allocates equal ``argument_bytes``."""
    one = MeshSpec(("data", "model"), (1, 1))
    for arch, kind in (("qwen7b", "decode"), ("hubert-xlarge", "train"),
                       ("mamba2-2.7b", "prefill")):
        cell = dryrun.build_cell(get_smoke_config(arch), SHAPES[kind], one,
                                 device="cpu")
        allocated = sum(t.nbytes for t in cell.args.values())
        assert allocated == dryrun.argument_bytes(cell), (arch, kind)
        meta = dryrun.build_cell(get_smoke_config(arch), SHAPES[kind], one)
        assert dryrun.argument_bytes(meta) == allocated


def test_roofline_baseline_detection():
    assert roofline.is_baseline({"options": {"fsdp": True,
                                             "compress": False}})
    assert not roofline.is_baseline({"options": {"fsdp": False}})
    assert roofline.nondefault_options({"q_chunk": 512, "pad_heads": 8}) == {
        "pad_heads": 8
    }


def test_collective_parser():
    hlo = """
  %ar = bf16[8,128]{1,0} all-reduce(bf16[8,128]{1,0} %x), replica_groups={}
  %ag.1 = f32[16,64]{1,0} all-gather(f32[8,64]{1,0} %y), dimensions={0}
  %nop = f32[4]{0} add(f32[4]{0} %a, f32[4]{0} %b)
"""
    c = dryrun.parse_collectives(hlo)
    assert c["all-reduce"]["count"] == 1
    assert c["all-reduce"]["bytes"] == 8 * 128 * 2
    assert c["all-gather"]["bytes"] == 16 * 64 * 4
    # ring all-reduce counts 2x on the link
    assert c["link_bytes"] == 2 * 8 * 128 * 2 + 16 * 64 * 4


def test_every_production_cell_builds_on_meta():
    n = 0
    for arch in ASSIGNED_ARCHS:
        for shape in get_config(arch).shapes():
            for mesh in ("single", "multi"):
                rec = dryrun.run_cell(arch, shape.name, mesh, flops=False)
                assert rec["status"] == "ok", (arch, shape.name, mesh,
                                               rec.get("error"))
                mem = rec["memory"]
                assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
                assert rec["bytes_per_device"] > 0
                assert rec["collective_bytes_per_device"] >= 0
                n += 1
    assert n == 2 * sum(len(get_config(a).shapes()) for a in ASSIGNED_ARCHS)


def test_compressed_multi_pod_plan():
    """JAX's XLA aborts on this cell; the port's plan drops pod from the
    data axes and adds the int32 pod sync of every gradient element a
    device holds."""
    cfg, shape = get_smoke_config("qwen7b"), SHAPES["train"]
    cell = dryrun.build_cell(cfg, shape, POD_MESH, compress=True)
    assert cell.rules.mapping["batch"] == ("data",)
    plain = dryrun.plan_collectives(
        dryrun.build_cell(cfg, shape, POD_MESH, compress=False))
    coll = dryrun.plan_collectives(cell)
    elems = sum(
        int(torch.tensor(cell.rules.shard_shape(t.shape, cell.axes[n])).prod())
        for n, t in cell.args.items() if n.startswith("params/"))
    n_params = sum(n.startswith("params/") for n in cell.args)
    no_pod = dryrun.plan_collectives(dryrun.build_cell(
        cfg, shape, MeshSpec(("data", "model"), (2, 4))))
    got = coll["detail"]["all-reduce"]
    base = no_pod["detail"]["all-reduce"]
    assert got["bytes"] - base["bytes"] == 4 * elems + 4 * n_params
    assert got["count"] - base["count"] == 1 + n_params
    assert plain["detail"] != coll["detail"]


def test_parse_variant():
    kw = hillclimb.parse_variant(
        "no-fsdp+no-remat+no-residual-shard+compress+train-kv-repeat"
        "+q-chunk=2048+pad-heads=8+moe-groups=16")
    assert kw == {"fsdp": False, "remat": False, "shard_residual": False,
                  "compress": True, "train_kv_repeat": True,
                  "q_chunk": 2048, "pad_heads": 8, "moe_groups": 16}
    assert hillclimb.parse_variant("") == {}
    with pytest.raises(ValueError, match="unknown variant"):
        hillclimb.parse_variant("fsdp-off")


def test_hillclimb_and_roofline_clis(tmp_path, capsys):
    out = tmp_path / "hill.jsonl"
    hillclimb.main(["--arch", "command-r-plus-104b", "--shape", "decode_32k",
                    "--variants", "no-fsdp,q-chunk=2048", "--out", str(out)])
    table = capsys.readouterr().out
    rows = [ln for ln in table.splitlines()
            if ln.startswith("| ") and not ln.startswith("| variant")]
    assert [r.split(" | ")[0] for r in rows] == [
        "| baseline", "| no-fsdp", "| q-chunk=2048"]
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok"] * 3
    assert recs[1]["options"] == {"fsdp": False}
    # without FSDP nothing is gathered, and each card holds more weights
    assert recs[1]["collectives"]["all-gather"]["count"] == 0
    assert (recs[1]["memory"]["argument_bytes"]
            > recs[0]["memory"]["argument_bytes"])

    runs = tmp_path / "dryrun.jsonl"
    dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(runs)])
    assert "dry-run complete: 2 ok, 0 fail" in capsys.readouterr().out
    roofline.main(["--in", str(runs), "--mesh", "multi"])
    report = capsys.readouterr().out
    assert "| mamba2-2.7b | long_500k |" in report
    assert report.rstrip().endswith("(none)")
