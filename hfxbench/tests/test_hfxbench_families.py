"""The architecture families (``families/<family>.py``): ``qwen1_5`` draws
the weights, and counts the work, exactly as the benchmark did before
the family files existed; and a family of another shape joins the
benchmark as new files alone, served end to end on the CPU."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hfxbench import catalog, model
from hfxbench.harness import Run, Step
from hfxbench.tests.conftest import smoke_config
from hfxbench.tests.test_hfxbench_catalog import _digests

REPO = Path(__file__).resolve().parents[2]

# Taken on the tree before the family files (whose model.py held these
# shapes, draws and counts); a seed must keep giving the same tensors.
QWEN7B_SHAPES = [
    ("embed", (151936, 4096)), ("final_norm", (4096,)),
    ("wq", (32, 4096, 4096)), ("wk", (32, 4096, 4096)),
    ("wv", (32, 4096, 4096)), ("wo", (32, 4096, 4096)),
    ("ln1", (32, 4096)), ("ln2", (32, 4096)),
    ("w_gate", (32, 4096, 11008)), ("w_up", (32, 4096, 11008)),
    ("w_down", (32, 11008, 4096)), ("bq", (32, 4096)), ("bk", (32, 4096)),
    ("bv", (32, 4096)), ("head", (151936, 4096))]
QWEN32B_SHAPES = [
    ("embed", (152064, 5120)), ("final_norm", (5120,)),
    ("wq", (64, 5120, 5120)), ("wk", (64, 5120, 1024)),
    ("wv", (64, 5120, 1024)), ("wo", (64, 5120, 5120)),
    ("ln1", (64, 5120)), ("ln2", (64, 5120)),
    ("w_gate", (64, 5120, 27392)), ("w_up", (64, 5120, 27392)),
    ("w_down", (64, 27392, 5120)), ("bq", (64, 5120)), ("bk", (64, 1024)),
    ("bv", (64, 1024)), ("head", (152064, 5120))]
# SHA-256 over every drawn tensor in order (name, shape, bytes), CPU,
# at the smoke width
WEIGHT_DIGESTS = {
    (3, "float32"):
        "500261a52fc1cd23262e051fd06cfa75c40b8f65b75daf3a3117c14c03b197d7",
    (3, "bfloat16"):
        "73c18a1f46cf23ce1671cf1b66da1dd0b55abb5d24236e74a5957c91d45a105b",
    (2 ** 31 + 7, "float32"):
        "969459e3e2064ce95f37994cb51ab3b72c54fe8cdfd409706ed10ddc843f7dde",
    (2 ** 31 + 7, "bfloat16"):
        "28788a7ca7765603451b5567465db4137ea336282a961c091b56742e102f48ab",
}
# the readers on test_hfxbench_roofline.py's hand-made run
READINGS = {
    "smoke": {
        "mfu.prefill": 1.0087280080889788e-06,
        "mfu.decode": 5.517373134328358e-05,
        "mfu.window": 3.680796019900498e-05,
        "paged_decode_attention_roofline.tail": 0.18340298507462685,
        "paged_decode_attention_roofline.tput": 0.18340298507462685},
    "qwen7b": {
        "mfu.prefill": 0.08577900353488373,
        "mfu.decode": 4.240550896716418,
        "mfu.window": 2.827086099104478,
        "paged_decode_attention_roofline.tail": 344.30853731343285,
        "paged_decode_attention_roofline.tput": 344.30853731343285},
    "qwen32b": {
        "mfu.prefill": 0.4077207933023256,
        "mfu.decode": 18.94632065910448,
        "mfu.window": 12.630906523383086,
        "paged_decode_attention_roofline.tail": 234.7558208955224,
        "paged_decode_attention_roofline.tput": 234.7558208955224},
}


@pytest.mark.parametrize("name, want", [("qwen7b", QWEN7B_SHAPES),
                                        ("qwen32b", QWEN32B_SHAPES)])
def test_qwen1_5_draw_order_and_shapes(name, want):
    cfg = catalog.load_json("configs", name)
    assert cfg["family"] == "qwen1_5"
    assert list(model.family(cfg).shapes(cfg).items()) == want


def _digest(weights: dict) -> str:
    h = hashlib.sha256()
    for name, t in weights.items():
        h.update(name.encode())
        h.update(repr(tuple(t.shape)).encode())
        t = t.contiguous()
        if t.dtype == torch.bfloat16:   # numpy has no bfloat16
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed, dtype", list(WEIGHT_DIGESTS))
def test_qwen1_5_weights_bit_for_bit(seed, dtype):
    weights = model.draw_weights(smoke_config(dtype), seed, "cpu")
    assert _digest(weights) == WEIGHT_DIGESTS[seed, dtype]


def _hand_made_run(cfg: dict) -> Run:
    steps = [
        Step("prefill_chunk", 0.0, 0.2, 13, 1, False, [(0, 10), (5, 3)], 1,
             n_completed=1),
        Step("decode", 0.2, 0.3, 2, 1, False, [(4, 1), (8, 1)], 2),
        Step("decode", 0.3, 0.5, 4, 2, False, [(5, 2), (9, 2)], 4),
        Step("decode", 0.6, 0.7, 2, 1, True, [(7, 1), (11, 1)], 2),
    ]
    return Run(cell={}, config=cfg, window_s=1.0, end_s=1.0, setup_s=3.0,
               reqs=[], steps=steps,
               trace={"busy_s": 0.025, "window_s": 0.1,
                      "kernels": {"void paged_group_kernel<16>": {"s": 1e-6,
                                                                 "n": 2},
                                  "gemm": {"s": 0.02, "n": 9}}},
               traced_from=0.6)


@pytest.mark.parametrize("cfg_name, metric", [
    (c, m) for c, readings in READINGS.items() for m in readings])
def test_qwen1_5_readers(cfg_name, metric):
    cfg = (smoke_config() if cfg_name == "smoke"
           else catalog.load_json("configs", cfg_name))
    got = catalog.reader(metric)(_hand_made_run(cfg))
    assert got == pytest.approx(READINGS[cfg_name][metric], rel=1e-12)


# A second family, written as a later configuration would bring it: the
# head width given (4 heads of 32 over d 64, where hidden / heads is 16)
# and no QKV bias.
FAMILY = '''"""A dense GQA decoder whose head width is given (``head_dim``),
with no QKV bias."""

from hfxbench import catalog

qwen = catalog.load_module("families", "qwen1_5")
std, state_dict = qwen.std, qwen.state_dict


def shapes(cfg):
    L, d, f, v = (cfg["num_hidden_layers"], cfg["hidden_size"],
                  cfg["intermediate_size"], cfg["vocab_size"])
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    kvd = cfg["num_key_value_heads"] * cfg["head_dim"]
    return {"embed": (v, d), "final_norm": (d,),
            "wq": (L, d, qd), "wk": (L, d, kvd), "wv": (L, d, kvd),
            "wo": (L, qd, d), "ln1": (L, d), "ln2": (L, d),
            "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
            "head": (v, d)}


def port_config(cfg):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=cfg["name"], family="dense", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"])


class Dims(qwen.Dims):
    @property
    def layer_params(self):
        qd, kvd = self.heads * self.head_dim, self.kv_heads * self.head_dim
        return 2 * self.d * qd + 2 * self.d * kvd + 3 * self.d * self.ff


def counts(cfg):
    return Dims(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
                heads=cfg["num_attention_heads"],
                kv_heads=cfg["num_key_value_heads"],
                head_dim=cfg["head_dim"], ff=cfg["intermediate_size"],
                vocab=cfg["vocab_size"])
'''

REFERENCE = '''"""Plain forward of the ``gqa_head_dim`` family: the Qwen1.5
reference's parts, at the given head width and with no QKV bias."""

import torch

from hfxbench import catalog

qwen = catalog.load_module("reference", "qwen1_5")
logits = qwen.logits
NAMES = ("wq", "wk", "wv", "wo", "ln1", "ln2", "w_gate", "w_up", "w_down")


def _layer(x, w, cfg, p):
    eps, theta, hd = cfg["rms_norm_eps"], cfg["rope_theta"], cfg["head_dim"]
    h, hkv, s = cfg["num_attention_heads"], cfg["num_key_value_heads"], len(x)
    n = qwen.rms_norm(x, w["ln1"], eps)
    q = qwen.rope(qwen._mm(n, w["wq"], p).view(s, h, hd).transpose(0, 1),
                  theta)
    k = qwen.rope(qwen._mm(n, w["wk"], p).view(s, hkv, hd).transpose(0, 1),
                  theta)
    v = qwen._mm(n, w["wv"], p).view(s, hkv, hd).transpose(0, 1)
    ctx = qwen.attention(q, k, v, p).transpose(0, 1).reshape(s, h * hd)
    x = x + qwen._mm(ctx, w["wo"], p)
    n = qwen.rms_norm(x, w["ln2"], eps)
    act = torch.nn.functional.silu(qwen._mm(n, w["w_gate"], p))
    return x + qwen._mm(act * qwen._mm(n, w["w_up"], p), w["w_down"], p)


@torch.no_grad()
def final_hidden(weights, cfg, seqs, precisions, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    ids = [torch.as_tensor(s, device=device).long() for s in seqs]
    xs = {p: [weights["embed"][i].float() for i in ids] for p in precisions}
    for layer in range(cfg["num_hidden_layers"]):
        w = {n: weights[n][layer].to(device).float() for n in NAMES}
        for p in precisions:
            xs[p] = [_layer(x, w, cfg, p) for x in xs[p]]
    fn = weights["final_norm"].to(device).float()
    return {p: [qwen.rms_norm(x, fn, cfg["rms_norm_eps"]) for x in xs[p]]
            for p in precisions}
'''

# one run of the copy's harness on the CPU, in a fresh interpreter whose
# ``hfxbench`` is the copy
RUN = """
import io, json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from hfxbench import catalog, harness
from hfxbench.tests.conftest import smoke_mix
cell, cfg, _ = catalog.resolve({cell!r})
res = harness.run_cell(cell, cfg, smoke_mix(), seed={seed}, seconds=1.5,
                       trace=True, device="cpu", t_start=time.perf_counter(),
                       bench=catalog.load_benchmark(), log=io.StringIO())
print(json.dumps({{"root": str(catalog.ROOT), "result": res}}))
"""


def test_another_family_is_added_without_an_edit(tmp_path):
    root = tmp_path / "hfxbench"
    shutil.copytree(catalog.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    (root / "families" / "gqa_head_dim.py").write_text(FAMILY)
    (root / "reference" / "gqa_head_dim.py").write_text(REFERENCE)
    cfg = {"name": "tiny_gqa_hd32", "source": "a test's own config",
           "family": "gqa_head_dim", "reference": "gqa_head_dim",
           "hidden_size": 64, "intermediate_size": 128,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 32, "num_hidden_layers": 2, "vocab_size": 256,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "dtype": "float32",
           "reduced": [], "engine": smoke_config()["engine"]}
    (root / "configs" / "tiny_gqa_hd32.json").write_text(json.dumps(cfg))
    cell = {"config": "tiny_gqa_hd32", "traffic": "four_task",
            "judge": "tail", "rate_rps": 20.0, "drain_s": 600.0,
            "trace": {"start_frac": 0.6, "steps": 8},
            "check": {"sample_tokens": 300, "limit_logit_gap": 1e-3}}
    (root / "cells" / "tiny_gqa_hd32.four_task.json").write_text(
        json.dumps(cell))
    # the cell joins BENCHMARK.json beside the repo's own cells, with the
    # metrics of qwen7b.four_task
    bench = catalog.load_benchmark(REPO)
    bench["configs"].append({"name": "tiny_gqa_hd32",
                             "source": cfg["source"],
                             "file": "hfxbench/configs/tiny_gqa_hd32.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_gqa_hd32.four_task",
                               "config": "tiny_gqa_hd32",
                               "traffic": "four_task", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen7b.four_task" in m.get("workloads", []):
            m["workloads"].append("tiny_gqa_hd32.four_task")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = catalog.listing(root)
    assert "gqa_head_dim" in found["families"]
    assert "gqa_head_dim" in found["reference"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = RUN.format(root=str(tmp_path), src=str(REPO / "src"),
                      cell="tiny_gqa_hd32.four_task", seed=2 ** 31 + 9)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(got["root"]) == root
    res = got["result"]
    assert res["correct"] is True, res["compared"]
    assert res["compared"]["logit_gap_max"]["value"] <= 1e-3
    assert res["attempted"] == 30 and res["failed"] == 0
    # the family's counts are what the MFU reader took (on a loaded host
    # the window before the profiled steps may hold no decode step, so
    # only prefill's reading is sure to be there)
    assert "mfu.prefill" in res["metrics"]
    after = _digests(root)
    assert {k: after[k] for k in before} == before   # nothing edited
