"""Sharding plans of the PyTorch port against the JAX package's.

- ``plan_arch`` and every ``arch_rules(...).mapping`` equal JAX's for all
  13 configs, the four stages, both production meshes, with and without
  ``fsdp``, ``exclude_pod`` and a ``batch_size`` (JAX in a subprocess
  with 512 host devices, its meshes from ``make_production_mesh``);
- the five ``plan_arch`` checks of tests/test_migrator_and_infra.py, on
  the port;
- ``AxisRules.spec`` / ``shard_shape``, ``use_rules`` and the meshes;
- ``Model.param_axes()`` and ``cache_logical_axes()`` equal JAX's leaf
  for leaf for every smoke config, through ``models/convert.py``'s names;
- ``kv_repeat``, ``vocab_pad`` and ``q_chunk``: logits and loss within
  1e-5 of JAX's on JAX's weights, prefill and a decode step too.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.build import build_model as jax_build  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    AxisRules,
    arch_rules,
    constrain,
    current_rules,
    mesh_sizes,
    plan_arch,
    use_rules,
)
from repro_torch.launch.mesh import MeshSpec, make_production_mesh  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402
from repro_torch.models.convert import _layer_map, _plan, params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("train", "prefill", "decode", "decode_long")
BATCHES = (None, 1, 48, 256)

# JAX's plans, printed as JSON by a subprocess with 512 host devices
_JAX_PLANS = r"""
import itertools, json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import REGISTRY, get_config
from repro.distributed.sharding import arch_rules, plan_arch
from repro.launch.mesh import make_production_mesh
meshes = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}
out = {"plans": {}, "rules": []}
for arch in sorted(REGISTRY):
    cfg = get_config(arch)
    for mk, mesh in meshes.items():
        out["plans"][f"{arch}|{mk}"] = plan_arch(cfg, mesh)
        for stage, fsdp, excl, bs in itertools.product(
                %(stages)r, (True, False), (False, True), %(batches)r):
            rules = arch_rules(cfg, mesh, stage=stage, fsdp=fsdp,
                               exclude_pod=excl, batch_size=bs)
            out["rules"].append([arch, mk, stage, fsdp, excl, bs,
                                 rules.mapping])
print(json.dumps(out))
""" % {"stages": STAGES, "batches": BATCHES}


def _jax_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _norm(v):
    """JSON turns tuples into lists: compare mappings as lists."""
    return list(v) if isinstance(v, tuple) else v


@pytest.fixture(scope="module")
def jax_plans():
    out = subprocess.run([sys.executable, "-c", _JAX_PLANS], env=_jax_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-1500:]
    return json.loads(out.stdout.strip().splitlines()[-1])


MESHES = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_plan_arch_and_arch_rules_equal_jax(jax_plans, arch):
    cfg = get_config(arch)
    for mk, mesh in MESHES.items():
        assert plan_arch(cfg, mesh) == jax_plans["plans"][f"{arch}|{mk}"], mk
    rows = [r for r in jax_plans["rules"] if r[0] == arch]
    assert len(rows) == 2 * len(STAGES) * 2 * 2 * len(BATCHES)
    for _, mk, stage, fsdp, excl, bs, want in rows:
        got = arch_rules(cfg, MESHES[mk], stage=stage, fsdp=fsdp,
                         exclude_pod=excl, batch_size=bs).mapping
        assert {k: _norm(v) for k, v in got.items()} == want, (
            mk, stage, fsdp, excl, bs)


def test_plan_arch_decisions():
    """tests/test_migrator_and_infra.py::test_plan_arch_decisions, on the
    port's plan over the 16 x 16 production mesh."""
    mesh = make_production_mesh()
    checks = {
        "command-r-plus-104b": dict(heads_sharded=True, kv_repeat=2,
                                    kv_sharded=True, vocab_pad=0),
        "gemma3-4b": dict(heads_sharded=False, kv_repeat=1,
                          kv_sharded=False, vocab_pad=0),
        "qwen2.5-14b": dict(heads_sharded=False, kv_repeat=1),
        "olmoe-1b-7b": dict(heads_sharded=True, kv_repeat=1,
                            kv_sharded=True),
        "mamba2-2.7b": dict(vocab_pad=(-50280) % 16),
    }
    for arch, want in checks.items():
        plan = plan_arch(get_config(arch), mesh)
        for k, v in want.items():
            assert plan[k] == v, (arch, k, plan)


def test_meshes_spec_and_shard_shape():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model") and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    rules = AxisRules({"batch": ("pod", "data"), "heads": "model",
                       "fsdp": ("pod", "data"), "ff": "model"}, multi)
    # an axis used by an earlier dim is dropped; trailing Nones trimmed
    assert rules.spec(("batch", "fsdp", "heads", None)) == (
        ("pod", "data"), None, "model")
    assert rules.spec((None, None)) == ()
    # uneven shards round up, as XLA pads them
    assert rules.shard_shape((33, 100, 8), ("batch", "ff", None)) == (2, 7, 8)
    assert rules.shard_shape((), ()) == ()
    assert mesh_sizes(MeshSpec(("data", "model"), (4, 2))) == {
        "data": 4, "model": 2}
    x = torch.ones(3)
    assert current_rules() is None
    with use_rules(rules):
        assert current_rules() is rules
        assert constrain(x, "batch") is x
    assert current_rules() is None


def test_mesh_sizes_of_a_device_mesh():
    """A DeviceMesh stands in for a MeshSpec (its dim names and shape)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(device_type="cpu")
        assert mesh_sizes(mesh) == {"data": 1, "model": 1}
        pod = init_device_mesh("cpu", (1, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))
        assert plan_arch(get_config("qwen7b"), pod)["kv_repeat"] == 1
        assert arch_rules(get_config("qwen7b"), pod).mapping["batch"] == (
            "pod", "data")
    finally:
        dist.destroy_process_group()


# -- logical axes ------------------------------------------------------------


class _Leaf:
    """A JAX leaf's shape (all ``convert._plan`` reads) with its axes."""

    def __init__(self, shape, axes):
        self.shape, self.axes = tuple(shape), tuple(axes)


def _strip_layers(axes, n_lead):
    assert axes[:n_lead] == ("layers",) * n_lead, axes
    return axes[n_lead:]


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_axes_equal_jax(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    jm = jax_build(jcfg)
    tree = jax.tree.map(lambda p, a: _Leaf(p.shape, a), jm.abstract_params(),
                        jm.param_axes())
    got = Model(cfg, device="meta").param_axes()
    want = {}
    for name, leaf, row in _plan(tree, cfg):
        want[name] = _strip_layers(leaf.axes, row[0] if row else 0)
        assert len(want[name]) == len(leaf.shape) - (row[0] if row else 0)
    assert got == want


_CACHE_LEAF = {("k",): "k", ("v",): "v", ("pos",): "pos",
               ("conv", "x"): "conv_x", ("conv", "bc"): "conv_bc",
               ("ssm",): "ssm"}


@pytest.mark.parametrize("arch", sorted(
    a for a in REGISTRY if not get_config(a).is_encoder_only))
def test_cache_logical_axes_equal_jax(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    jm = jax_build(jcfg)
    model = Model(cfg, device="meta")
    got = model.cache_logical_axes()
    assert [set(c) for c in got] == [set(c) for c in model.init_cache(2, 16)]
    shapes = jax.eval_shape(lambda: jm.init_cache(2, 16))
    layers = _layer_map(cfg)
    seen = set()
    for si, seg in enumerate(jm.cache_logical_axes()):
        for key in ((si, None), *((si, k) for k in seg)):
            if key not in layers:
                continue
            sub = seg if key[1] is None else seg[key[1]]
            sub_shapes = shapes[si] if key[1] is None else shapes[si][key[1]]
            idx, _ = layers[key]
            for path, port_leaf in _CACHE_LEAF.items():
                node, shp = sub, sub_shapes
                try:
                    for p in path:
                        node, shp = node[p], shp[p]
                except (KeyError, TypeError):
                    continue
                n_lead = len(shp.shape) - len(got[idx[0]][port_leaf])
                assert np.prod(shp.shape[:n_lead]) == len(idx)
                for i in idx:
                    assert got[i][port_leaf] == _strip_layers(tuple(node),
                                                              n_lead)
                    seen.add((i, port_leaf))
    assert seen == {(i, k) for i, c in enumerate(got) for k in c}


# -- kv_repeat, vocab_pad, q_chunk --------------------------------------------

# 8 query / 2 KV heads and a vocabulary above 10 000 on a 4-way model
# axis: the plan repeats each KV head twice and pads the vocabulary
PLAN_MESH = MeshSpec(("data", "model"), (1, 4))


def _planned(cfg):
    return dataclasses.replace(cfg, n_heads=8, n_kv_heads=2,
                               vocab_size=10_001)


def test_kv_repeat_vocab_pad_and_q_chunk_match_jax():
    cfg = _planned(get_smoke_config("qwen7b"))
    jcfg = _planned(jax_smoke("qwen7b"))
    plan = plan_arch(cfg, PLAN_MESH)
    assert (plan["kv_repeat"], plan["vocab_pad"]) == (2, 3)
    knobs = dict(kv_repeat=2, vocab_pad=3, q_chunk=16)
    jm = jax_build(jcfg, **knobs)
    jp = jm.init(jax.random.key(3))
    model = Model(cfg, device="cpu", use_kernels=False, **knobs)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    assert model.embed.shape == (10_004, cfg.d_model)

    rng = np.random.default_rng(0)
    b, s = 2, 40                  # 3 query chunks, the last one padded
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_logits = np.asarray(jm.forward(jp, {k: jnp.asarray(v)
                                             for k, v in batch.items()}))
    assert want_logits.shape == (b, s, 10_004)
    with torch.no_grad():
        got_logits = model.forward(tb).numpy()
        got_loss = float(model.loss(tb))
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-5, atol=1e-5)
    want_loss = float(jm.loss(jp, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))
    assert abs(got_loss - want_loss) < 1e-5

    # prefill into caches of n_kv_heads * kv_repeat heads, then a step
    lens = np.array([s, s - 7], np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(batch["tokens"]), jnp.asarray(lens),
                        cache_len=s + 4)
    tl, tc = model.prefill(tb["tokens"], torch.from_numpy(lens),
                           cache_len=s + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    assert tc[0]["k"].shape == (b, 4, s + 4, cfg.resolved_head_dim)
    assert model.init_cache(b, s)[0]["k"].shape[1] == 4
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens))
    td, _ = model.decode_step(tc, torch.from_numpy(nxt),
                              torch.from_numpy(lens))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
