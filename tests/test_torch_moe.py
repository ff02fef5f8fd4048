"""The port's mixture-of-experts FFN (``repro_torch/models/moe.py``)
against the JAX package's ``repro/models/moe.py::moe_ffn`` on the same
numpy-seeded inputs and weights: the selected experts, the drop mask
(the JAX selections dispatched by a numpy reference of the sort-based
rule), ``y``, ``lb_loss`` and ``drop_frac``; and the MoE layer's
parameters in the port's ``Model`` (mapping from the JAX tree, init).

f32 on the CPU, within 1e-5.  The cases: olmoe's smoke config (8
experts, top-2) at the default capacity factor, where assignments drop;
the same with padding rows (all-zero rows route through a uniform
softmax, an exact tie that both packages break to the lowest expert
ids) and a capacity factor with no drops; two dispatch groups; phi3.5's
smoke config; and olmoe's 64 experts, top-8 at a narrow width.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.build import Model, MoEBlock  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-5


def _with_moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def _cfgs(arch, **kw):
    """(port cfg, JAX cfg) of the smoke config, the MoE fields replaced
    by ``kw``."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    if kw:
        cfg, jcfg = _with_moe(cfg, **kw), _with_moe(jcfg, **kw)
    return cfg, jcfg


# name -> (arch, MoE overrides, d_model override, x shape, zero rows)
CASES = {
    "drops": ("olmoe-1b-7b", {}, None, (3, 7), ()),
    "padding_rows": ("olmoe-1b-7b", {}, None, (4, 6), (1, 5, 6, 7, 23)),
    "no_drops": ("olmoe-1b-7b", dict(capacity_factor=8.0), None, (3, 7),
                 (0, 2)),
    "groups": ("olmoe-1b-7b", dict(dispatch_groups=2), None, (4, 5), (3,)),
    "phi3.5": ("phi3.5-moe-42b-a6.6b", {}, None, (2, 9), ()),
    "64_experts_top8": ("olmoe-1b-7b", dict(num_experts=64, top_k=8,
                                            expert_d_ff=32), 32, (2, 24),
                        (4,)),
}


def _case(name):
    arch, kw, d, (b, s), zero_rows = CASES[name]
    cfg, jcfg = _cfgs(arch, **kw)
    if d is not None:
        cfg = dataclasses.replace(cfg, d_model=d)
        jcfg = dataclasses.replace(jcfg, d_model=d)
    rng = np.random.default_rng(sum(map(ord, name)))
    params = {
        n: (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
        for n, shape in jmoe.moe_param_shapes(jcfg).items()}
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    x.reshape(b * s, -1)[list(zero_rows)] = 0.0
    return cfg, jcfg, params, x


def _np_keep(sel: np.ndarray, cap: int) -> np.ndarray:
    """The sort-based rule in numpy, per group: an assignment is kept
    iff fewer than ``cap`` assignments to its expert precede it in
    (token, k) order.  Returned in (G, Tg, k) order."""
    g, tg, k = sel.shape
    keep = np.zeros((g, tg * k), bool)
    for gi in range(g):
        flat = sel[gi].reshape(-1)
        seen: dict = {}
        for i, ex in enumerate(flat):
            keep[gi, i] = seen.get(ex, 0) < cap
            seen[ex] = seen.get(ex, 0) + 1
    return keep.reshape(g, tg, k)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_jax(name):
    cfg, jcfg, params, x = _case(name)
    b, s, d = x.shape
    m = cfg.moe
    g = m.dispatch_groups or 1
    cap = moe.capacity(cfg, b * s // g)
    assert cap == jmoe.capacity(jcfg, b * s // g)

    # the selections first: JAX's top_k of its f32 softmax
    xg = x.reshape(g, -1, d)
    jprobs = jax.nn.softmax(jnp.asarray(xg) @ jnp.asarray(
        params["w_router"]), axis=-1)
    jgate, jsel = jax.lax.top_k(jprobs, m.top_k)
    tp = {n: torch.tensor(v) for n, v in params.items()}
    probs, gate, sel = moe.route(tp, torch.tensor(xg), cfg)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(gate.numpy(), np.asarray(
        jgate / jgate.sum(-1, keepdims=True)), rtol=TOL, atol=TOL)
    for r in CASES[name][4]:       # zero rows: a uniform softmax, a tie
        gi, ti = divmod(r, xg.shape[1])
        assert sel[gi, ti].tolist() == list(range(m.top_k))

    # the drop mask: the port's dispatch against the numpy rule
    order, _, _, keep = moe.dispatch(sel, cap)
    unsorted = torch.empty_like(keep).scatter_(1, order, keep)
    want_keep = _np_keep(np.asarray(jsel), cap)
    np.testing.assert_array_equal(unsorted.view(sel.shape).numpy(),
                                  want_keep)
    if name in ("drops", "padding_rows"):
        assert not want_keep.all()
    if name == "no_drops":
        assert want_keep.all()

    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), jcfg)
    y, aux = moe.moe_ffn(tp, torch.tensor(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for key in ("lb_loss", "drop_frac"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=TOL, atol=TOL)
    assert float(aux["drop_frac"]) == pytest.approx(
        1 - want_keep.mean(), abs=1e-7)


def test_moe_ffn_bf16_keeps_dtype_and_tracks_f32():
    """In bf16 the router and experts run in bf16 and the output keeps
    the input's dtype; it stays within bf16 rounding of the f32 run."""
    cfg, _, params, x = _case("no_drops")
    tp = {n: torch.tensor(v) for n, v in params.items()}
    y32, _ = moe.moe_ffn(tp, torch.tensor(x), cfg)
    y16, aux = moe.moe_ffn({n: t.bfloat16() for n, t in tp.items()},
                           torch.tensor(x).bfloat16(), cfg)
    assert y16.dtype == torch.bfloat16 and aux["drop_frac"].dtype == \
        torch.float32
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), atol=0.1,
                               rtol=0.05)


def test_moe_layers_map_from_jax_and_init_in_place():
    """olmoe's smoke Model: each layer is a MoEBlock whose ``moe``
    leaves are the JAX tree's ``segments[0]["moe"]`` rows; ``init``
    draws them from the generator with std 1/sqrt(fan_in) (the router
    too), leaving no expert zero."""
    cfg = get_smoke_config("olmoe-1b-7b")
    jm = jax_build(jax_smoke("olmoe-1b-7b"))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(2)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    assert model.kinds == ["moe"] * cfg.n_layers
    assert all(isinstance(blk, MoEBlock) for blk in model.layers)
    for i in range(cfg.n_layers):
        for n, t in model.layers[i].moe.items():
            np.testing.assert_array_equal(t.numpy(),
                                          tree["segments"][0]["moe"][n][i])
    fresh = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for blk in fresh.layers:
        for n, t in blk.moe.items():
            fan_in = t.shape[-2]
            assert t.abs().amax(dim=(-2, -1)).min() > 0, n
            assert float(t.std()) == pytest.approx(fan_in ** -0.5, rel=0.2)
