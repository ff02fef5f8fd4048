"""The port's architecture registry against the JAX package's: every
config equal field for field (full width and smoke), the same parameter
counts, the shape suite (``SHAPES``, ``shapes()``, ``skipped_shapes()``,
``mfu_flops`` exactly), ``ASSIGNED_ARCHS`` and ``PAPER_MODELS``, the
JAX tree's leaves as groups of the port's tensors, and the port's
``Model`` laid out at full width as
``convert.param_shapes_from_jax`` maps the JAX tree's shapes
(``jax.eval_shape``: nothing is materialized; the port's side is built
on the meta device) — the decoders and the encoder-only hubert.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    REGISTRY,
    SHAPES,
    get_config,
    get_smoke_config,
    mfu_flops,
)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    param_shapes_from_jax,
    params_from_jax,
    stacked_leaves,
)

DECODERS = sorted(n for n, c in JAX_REGISTRY.items() if c.causal)
NEW = ["qwen32b", "llama70b", "qwen2.5-14b", "internlm2-20b",
       "command-r-plus-104b", "chameleon-34b", "olmoe-1b-7b",
       "phi3.5-moe-42b-a6.6b"]


def test_registry_holds_every_jax_decoder():
    """Every JAX config: the 12 decoders and hubert-xlarge."""
    assert len(DECODERS) == 12
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY) == sorted(
        DECODERS + ["hubert-xlarge"])
    assert set(NEW) < set(REGISTRY)


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_config_equals_jax_field_for_field(name):
    """Full width and smoke: the same fields and values, ``source``
    included (the MoE and SSM sub-configs compared as dicts); the same
    layer pattern, parameter count and active parameter count."""
    for got, jcfg in ((get_config(name), jax_config(name)),
                      (get_smoke_config(name), jax_smoke(name))):
        assert dataclasses.asdict(got) == {
            f.name: (dataclasses.asdict(getattr(jcfg, f.name))
                     if dataclasses.is_dataclass(getattr(jcfg, f.name))
                     else getattr(jcfg, f.name))
            for f in dataclasses.fields(ModelConfig)}
        assert got.layer_pattern() == jcfg.layer_pattern()
        assert got.param_count() == jcfg.param_count()
        assert got.active_param_count() == jcfg.active_param_count()
    assert get_config(name).source != ""


@pytest.mark.parametrize("name", NEW)
def test_full_width_layout_maps_from_jax_shapes(name):
    """The JAX tree of the full-width config maps onto the port's
    parameters one for one, shape for shape, and counts
    ``param_count()`` (qwen32b 32.5 B, olmoe 6.9 B, command-r-plus
    104 B: shapes only)."""
    cfg = get_config(name)
    tree = jax.eval_shape(jax_build(jax_config(name)).init,
                          jax.random.key(0))
    shapes = param_shapes_from_jax(tree, cfg)
    model = Model(cfg, device="meta")
    assert shapes == {k: tuple(v.shape)
                      for k, v in model.state_dict().items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg.param_count()
    assert model.kinds == ["moe" if cfg.moe else "dense"] * cfg.n_layers
    assert cfg.resolved_head_dim == 128


def test_chameleon_token_vq_frontend_is_the_token_path():
    """chameleon's ``token+vq`` frontend (VQ image ids in the text
    vocabulary) builds and prefills as the plain token path, with the
    JAX model's logits on the same weights."""
    cfg = get_smoke_config("chameleon-34b")
    assert cfg.frontend == "token+vq"
    jm = jax_build(jax_smoke("chameleon-34b"))
    jp = jm.init(jax.random.key(7))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 11))
    toks = toks.astype(np.int32)
    lens = np.array([11, 6], np.int32)
    want, _ = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens))
    got, _ = model.prefill(torch.as_tensor(toks), torch.as_tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert model.supports_prefix_cache and model.supports_spec_decode


def test_hubert_full_width_layout_maps_from_jax_shapes():
    """hubert-xlarge at full width: 48 encoder layers laid out as the JAX
    tree's shapes map, ``embed`` kept beside the codebook ``head`` (JAX's
    ``init`` keeps it; no gradient reaches it), 1.2597 B parameters."""
    cfg = get_config("hubert-xlarge")
    tree = jax.eval_shape(jax_build(jax_config("hubert-xlarge")).init,
                          jax.random.key(0))
    shapes = param_shapes_from_jax(tree, cfg)
    model = Model(cfg, device="meta")
    assert shapes == {k: tuple(v.shape)
                      for k, v in model.state_dict().items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg.param_count()
    assert round(cfg.param_count() / 1e9, 4) == 1.2597
    assert model.kinds == ["encoder"] * 48
    assert shapes["embed"] == shapes["head"] == (504, 1280)
    assert cfg.resolved_head_dim == 80


def _fields(cfg) -> dict:
    """A config's fields, its MoE and SSM sub-configs as dicts."""
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(ModelConfig)}


def test_shape_tables_and_arch_pools_equal_jax():
    """``SHAPES`` entry for entry (fields and ``tokens``); the graded pool
    and the paper's models by key, in JAX's order, field for field;
    ``REGISTRY`` their union in JAX's order; all exported."""
    assert list(SHAPES) == list(jconfigs.SHAPES)
    for k, shape in SHAPES.items():
        want = jconfigs.SHAPES[k]
        assert dataclasses.asdict(shape) == dataclasses.asdict(want)
        assert shape.tokens == want.tokens
    for pool in ("ASSIGNED_ARCHS", "PAPER_MODELS"):
        got, want = getattr(configs, pool), getattr(jconfigs, pool)
        assert list(got) == list(want)
        for name in got:
            assert dataclasses.asdict(got[name]) == _fields(want[name])
    assert list(REGISTRY) == list(JAX_REGISTRY) == [
        *configs.ASSIGNED_ARCHS, *configs.PAPER_MODELS]
    assert set(jconfigs.__all__) <= set(configs.__all__)


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_shape_suite_and_mfu_flops_equal_jax(name):
    """Full width and smoke: the shapes that apply and the skipped ones
    with their reasons, ``attention_free`` and ``sub_quadratic``; and
    ``mfu_flops`` for every ``SHAPES`` entry, the same Python float."""
    for cfg, jcfg in ((get_config(name), jax_config(name)),
                      (get_smoke_config(name), jax_smoke(name))):
        assert [dataclasses.asdict(s) for s in cfg.shapes()] == [
            dataclasses.asdict(s) for s in jcfg.shapes()]
        assert list(cfg.skipped_shapes()) == list(jcfg.skipped_shapes())
        assert cfg.attention_free == jcfg.attention_free
        assert cfg.sub_quadratic == jcfg.sub_quadratic
        for key, shape in SHAPES.items():
            got = mfu_flops(cfg, shape)
            want = jconfigs.mfu_flops(jcfg, jconfigs.SHAPES[key])
            assert type(got) is float and got == want, (key, got, want)


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_stacked_leaves_are_the_jax_trees_leaves(name):
    """Each JAX leaf of the smoke config, filled with its own index,
    lands on exactly the port tensors ``stacked_leaves`` groups
    together (a leaf stacks a parameter over a segment's layers; the
    pod sync gives each leaf one scale)."""
    cfg = get_smoke_config(name)
    tree = jax.eval_shape(jax_build(jax_smoke(name)).init, jax.random.key(0))
    leaves, treedef = jax.tree.flatten(tree)
    filled = jax.tree.unflatten(treedef, [
        np.full(leaf.shape, k, np.float32) for k, leaf in enumerate(leaves)])
    ported = params_from_jax(filled, cfg)
    by_leaf: dict = {}
    for n, t in ported.items():
        assert t.min() == t.max()
        by_leaf.setdefault(int(t.flatten()[0]), set()).add(n)
    names = dict(Model(cfg, device="meta").named_parameters())
    groups = stacked_leaves(cfg, names)
    assert sorted(map(sorted, groups)) == sorted(map(sorted,
                                                     by_leaf.values()))
    assert len(groups) == len(leaves)
