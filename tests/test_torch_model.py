"""Model of the PyTorch port against the JAX ``Model`` on the same
weights: parameter conversion (one dense segment, gemma3's
local/global segments and groups, mamba2's Mamba-2 segment and zamba2's
group with the shared attention block — the last two also at full
width, from shapes alone), ``chunk_step`` logits and ``decode_block``
tokens on the paged plane, ``prefill`` / ``decode_step`` logits and
caches and ``decode_block_slots`` tokens on the slot plane, chunked
against monolithic prefill for the SSM and the hybrid, and the
capability flags and refusals.

f32 on the CPU.  Logits tolerance 1e-4: the two frameworks sum the
same f32 products in another order, through up to 13 layers and a
256-way head.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    param_shapes_from_jax,
    params_from_jax,
)
from repro_torch.serving.kv_manager import PagedKVManager  # noqa: E402

CFG = get_smoke_config("qwen7b")
JCFG = jax_smoke("qwen7b")
JMODEL = jax_build(JCFG)
JPARAMS = JMODEL.init(jax.random.key(0))
TREE = jax.tree.map(np.asarray, JPARAMS)
_JIT = {"chunk": jax.jit(JMODEL.chunk_step)}


def _port_model():
    m = Model(CFG, device="cpu")
    m.load_state_dict(params_from_jax(TREE, CFG))
    return m


# gemma3 on the CPU: the smoke config (7 layers — three uniform
# segments, local 5 / global 1 / local 1, window 8) and a 13-layer cut
# that the JAX package lays out as a group segment of 2 x (5 local,
# 1 global) plus a 1-layer local tail — the full config's layout
GEMMA_LAYERS = {"smoke": None, "13-layer": 13}


@functools.lru_cache(maxsize=None)
def _gemma(which):
    """(port cfg, JAX model, JAX params, numpy tree) for one gemma3 cut."""
    cfg, jcfg = get_smoke_config("gemma3-4b"), jax_smoke("gemma3-4b")
    if GEMMA_LAYERS[which]:
        cfg = dataclasses.replace(cfg, n_layers=GEMMA_LAYERS[which])
        jcfg = dataclasses.replace(jcfg, n_layers=GEMMA_LAYERS[which])
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(1))
    return cfg, jm, jp, jax.tree.map(np.asarray, jp)


def _gemma_port(which, use_kernels=True):
    cfg, _, _, tree = _gemma(which)
    m = Model(cfg, device="cpu", use_kernels=use_kernels)
    m.load_state_dict(params_from_jax(tree, cfg))
    return m


def test_params_from_jax_maps_every_leaf_exactly_once():
    sd = params_from_jax(TREE, CFG)
    leaves = jax.tree_util.tree_leaves_with_path(TREE)
    # a stacked layer leaf fans out to n_layers tensors, a top-level
    # leaf to one — and the names never collide
    stacked = [p for p, _ in leaves if p[0].key == "segments"]
    assert len(sd) == (len(leaves) - len(stacked)
                       + CFG.n_layers * len(stacked))
    model = Model(CFG, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        model.layers[1].attn["wq"].numpy(),
        TREE["segments"][0]["attn"]["wq"][1])
    np.testing.assert_array_equal(model.head.numpy(), TREE["head"])
    extra = dict(TREE, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        params_from_jax(extra, CFG)


@pytest.mark.parametrize("which", list(GEMMA_LAYERS))
def test_params_from_jax_maps_gemma3_segments_and_groups(which):
    """Each leaf used exactly once: a uniform segment's leaf fans out to
    its count of layers, a group's ``(n_groups, inner_count, ...)`` leaf
    to n_groups x inner_count layers, in execution order."""
    cfg, jm, _, tree = _gemma(which)
    sd = params_from_jax(tree, cfg)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    n_lead = {1: 0, 2: 0}
    fan = 0
    for path, leaf in leaves:
        if path[0].key != "segments":
            fan += 1
            continue
        spec = jm.segments[path[1].idx]
        lead = 2 if spec.kind == "group" else 1
        n_lead[lead] += 1
        fan += int(np.prod(leaf.shape[:lead]))
    assert len(sd) == fan
    assert bool(n_lead[2]) == (which == "13-layer")
    model = Model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    wq = lambda i: model.layers[i].attn["wq"].numpy()  # noqa: E731
    segs = tree["segments"]
    if which == "13-layer":
        np.testing.assert_array_equal(wq(1), segs[0]["local"]["attn"]["wq"][0, 1])
        np.testing.assert_array_equal(wq(5), segs[0]["global"]["attn"]["wq"][0, 0])
        np.testing.assert_array_equal(wq(6), segs[0]["local"]["attn"]["wq"][1, 0])
        np.testing.assert_array_equal(wq(11), segs[0]["global"]["attn"]["wq"][1, 0])
        np.testing.assert_array_equal(wq(12), segs[1]["attn"]["wq"][0])
    else:
        np.testing.assert_array_equal(wq(4), segs[0]["attn"]["wq"][4])
        np.testing.assert_array_equal(wq(5), segs[1]["attn"]["wq"][0])
        np.testing.assert_array_equal(wq(6), segs[2]["attn"]["wq"][0])
    assert model.windows == [0 if k == "global" else cfg.window
                             for k, n in cfg.layer_pattern()
                             for _ in range(n)]
    assert model.head is None          # tied: the head is embed.T


@functools.lru_cache(maxsize=None)
def _gemma_jax_run(which, n_decode=14):
    """JAX prefill of three ragged prompts, then ``n_decode`` greedy
    decode steps: the inputs and logits of every step."""
    _, jm, jp, _ = _gemma(which)
    rng = np.random.default_rng(3)
    b, s, max_len = 3, 32, 64
    lens = np.array([32, 13, 5], np.int32)
    toks = rng.integers(0, 256, (b, s)).astype(np.int32)
    lj, jc = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, jnp.asarray(toks), jnp.asarray(lens), cache_len=max_len)
    steps = [(toks, lens, np.asarray(lj))]
    pos, last = lens.copy(), np.asarray(lj).argmax(-1).astype(np.int32)
    step = jax.jit(jm.decode_step)
    for _ in range(n_decode):
        lj, jc = step(jp, jc, jnp.asarray(last), jnp.asarray(pos))
        steps.append((last, pos, np.asarray(lj)))
        last, pos = np.asarray(lj).argmax(-1).astype(np.int32), pos + 1
    return steps, max_len


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("which", list(GEMMA_LAYERS))
def test_gemma3_prefill_and_decode_logits_match_jax(which, use_kernels):
    """Ragged prompts (32, 13, 5 tokens) then 14 decode steps: row 2
    decodes positions 5 to 18, across the window of 8 into the ring.
    ``use_kernels`` picks the kernels' plain versions (flash and decode
    attention) or the chunked / masked plain routes."""
    steps, max_len = _gemma_jax_run(which)
    model = _gemma_port(which, use_kernels)
    (toks, lens, want), rest = steps[0], steps[1:]
    got, caches = model.prefill(torch.as_tensor(toks), torch.as_tensor(lens),
                                cache_len=max_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert [c["k"].shape[2] for c in caches] == [
        max_len if w == 0 else w for w in model.windows]
    for last, pos, want in rest:
        got, caches = model.decode_step(caches, torch.as_tensor(last),
                                        torch.as_tensor(pos))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    ring = caches[0]["pos"].numpy()          # a local layer's ring
    assert sorted(ring[2]) == list(range(11, 19))   # positions 5..18 written


def test_gemma3_decode_block_slots_matches_jax_with_mid_block_stops():
    """Tokens, valid lanes, final last/pos identical to JAX's slot-plane
    fused decode block — row 0 stopping on EOS and row 1 on its output
    budget mid-block, row 2 frozen — crossing the window of 8."""
    _, jm, jp, _ = _gemma("smoke")
    model = _gemma_port("smoke")
    b, max_len, k = 3, 32, 8
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 256, (b, 6)).astype(np.int32)
    lens = np.array([6, 4, 2], np.int32)
    jblock = jax.jit(jm.decode_block_slots, static_argnames="k")

    def run(eos, rem):
        lj, jc = jax.jit(jm.prefill, static_argnames="cache_len")(
            jp, jnp.asarray(toks), jnp.asarray(lens), cache_len=max_len)
        _, tc = model.prefill(torch.as_tensor(toks), torch.as_tensor(lens),
                              cache_len=max_len)
        last = np.asarray(lj).argmax(-1).astype(np.int32)
        args = (last, lens, np.array([True, True, False]), rem)
        (jt, jv, jl, jpos), _ = jblock(
            jp, jc, *map(jnp.asarray, args), jnp.int32(eos),
            jnp.int32(max_len), k=k)
        (tt, tv, tl, tpos), _ = model.decode_block_slots(
            tc, *map(torch.as_tensor, args), eos, max_len, k=k)
        for a, w in ((tt, jt), (tv, jv), (tl, jl), (tpos, jpos)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        return tt.numpy(), tv.numpy()

    toks_out, valid = run(-1, np.array([8, 8, 0], np.int32))
    assert valid[:2].all() and not valid[2].any()
    eos = int(toks_out[0, 3])        # row 0 emits it at lane 3
    toks_out, valid = run(eos, np.array([8, 2, 0], np.int32))
    first = int(np.argmax(toks_out[0] == eos))
    assert valid[0, :first + 1].all() and not valid[0, first + 1:].any()
    assert valid[1, :2].all() and not valid[1, 2:].any()


def _run_both(ps, chunks, n_decode):
    """Drive both models through the same chunked prefill and C == 1
    decode steps; return the per-step logits of each."""
    b, max_len = 3, 32
    rng = np.random.default_rng(ps)
    kv = PagedKVManager(b, max_len, ps, device="cpu")
    jc = JMODEL.init_paged_cache(b, max_len, ps)
    model = _port_model()
    tc = model.init_paged_cache(b, max_len, ps)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in (11, 6, 0)]       # row 2 stays idle
    pos = np.zeros(b, np.int32)
    out_j, out_t = [], []

    def step(tokens, start, lens):
        nonlocal jc, tc
        args = (kv.table, tokens, start, lens)
        lj, jc = _JIT["chunk"](JPARAMS, jc, *map(jnp.asarray, args))
        lt, tc = model.chunk_step(tc, *map(torch.as_tensor, args))
        live = lens > 0
        out_j.append(np.asarray(lj)[live])
        out_t.append(lt.numpy()[live])
        return np.asarray(lj)

    while any(pos[i] < len(p) for i, p in enumerate(prompts)):
        tokens = np.zeros((b, chunks), np.int32)
        lens = np.zeros(b, np.int32)
        for i, p in enumerate(prompts):
            n = min(chunks, len(p) - pos[i])
            tokens[i, :n] = p[pos[i]:pos[i] + n]
            lens[i] = n
            assert kv.ensure(i, int(pos[i] + n))
        lj = step(tokens, pos.copy(), lens)
        pos += lens
    last = lj.argmax(-1).astype(np.int32)
    for _ in range(n_decode):
        lens = np.array([1, 1, 0], np.int32)
        for i in range(2):
            assert kv.ensure(i, int(pos[i]) + 1)
        lj = step(last[:, None], pos.copy(), lens)
        last = lj.argmax(-1).astype(np.int32)
        pos += lens
    return out_j, out_t, jc, tc


@pytest.mark.parametrize("ps", [4, 8])
def test_chunk_step_logits_match_jax(ps):
    out_j, out_t, jc, tc = _run_both(ps, chunks=4, n_decode=3)
    for lj, lt in zip(out_j, out_t):
        np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc[0]["k_pages"].numpy(),
                               np.asarray(jc[0]["k_pages"]),
                               rtol=1e-4, atol=1e-4)


def test_decode_block_matches_jax_with_mid_block_stops():
    """Tokens, valid lanes, final last/pos identical to JAX's fused
    decode block — with row 0 stopping on EOS and row 1 on its output
    budget mid-block, and row 2 idle."""
    ps, b, max_len, k = 4, 3, 32, 8
    model = _port_model()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in (9, 5)]

    def fresh():
        kv = PagedKVManager(b, max_len, ps, device="cpu")
        jc = JMODEL.init_paged_cache(b, max_len, ps)
        tc = model.init_paged_cache(b, max_len, ps)
        tokens = np.zeros((b, 9), np.int32)
        lens = np.zeros(b, np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            lens[i] = len(p)
            assert kv.ensure(i, len(p) + k)
        args = (kv.table, tokens, np.zeros(b, np.int32), lens)
        lj, jc = _JIT["chunk"](JPARAMS, jc, *map(jnp.asarray, args))
        _, tc = model.chunk_step(tc, *map(torch.as_tensor, args))
        return kv, jc, tc, np.asarray(lj).argmax(-1).astype(np.int32), lens

    def run(eos, rem):
        kv, jc, tc, last, pos = fresh()
        alive = np.array([True, True, False])
        args = (last, pos, alive, rem)
        (jt, jv, jl, jp), _ = jax.jit(JMODEL.decode_block,
                                      static_argnames="k")(
            JPARAMS, jc, jnp.asarray(kv.table), *map(jnp.asarray, args),
            jnp.int32(eos), jnp.int32(max_len), k=k)
        (tt, tv, tl, tp), _ = model.decode_block(
            tc, torch.as_tensor(kv.table), *map(torch.as_tensor, args),
            eos, max_len, k=k)
        for a, w in ((tt, jt), (tv, jv), (tl, jl), (tp, jp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        return tt.numpy(), tv.numpy()

    toks, valid = run(-1, np.array([8, 8, 0], np.int32))
    assert valid[:2].all() and not valid[2].any()
    eos = int(toks[0, 3])           # row 0 emits it at lane 3
    toks, valid = run(eos, np.array([8, 2, 0], np.int32))
    first = int(np.argmax(toks[0] == eos))
    assert valid[0, :first + 1].all() and not valid[0, first + 1:].any()
    assert valid[1, :2].all() and not valid[1, 2:].any()


def test_supports_flags_and_refusals_mirror_jax():
    """The port's capability flags equal the JAX Model's for qwen7b
    (paged plane), gemma3 (slot plane only: its sliding-window layers
    refuse paged caches), mamba2 and zamba2 (both planes; no prefix
    cache or spec decode, their SSM state being slot-resident); the
    kinds not ported yet (MoE, encoder) refuse to build, naming their
    ROADMAP item.  (mamba2 and zamba2 refused to build before they were
    ported; their parity tests are below.)"""
    flags = ("supports_chunked", "supports_prefix_cache",
             "supports_spec_decode")
    model = _port_model()
    for flag in flags:
        assert getattr(model, flag) is getattr(JMODEL, flag) is True
    gemma = _gemma_port("smoke")
    jgemma = _gemma("smoke")[1]
    for flag in flags:
        assert getattr(gemma, flag) is getattr(jgemma, flag) is False
    with pytest.raises(ValueError, match="init_cache"):
        gemma.init_paged_cache(2, 16, 4)
    for arch in SSM_ARCHS:
        port, jm = _ssm_port(arch), _ssm(arch)[1]
        assert [getattr(port, f) for f in flags] == [
            getattr(jm, f) for f in flags] == [True, False, False]
    for arch in ("olmoe-1b-7b", "hubert-xlarge"):
        jcfg = jax_smoke(arch)
        fields = {f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(ModelConfig)}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(ModelConfig(**fields), device="cpu")


# ---------------------------------------------------------------------------
# Mamba-2 (mamba2-2.7b) and the hybrid (zamba2-7b)
# ---------------------------------------------------------------------------

# smoke configs: mamba2 is one uniform segment of 2 Mamba-2 layers;
# zamba2's 7 layers are a group segment of 2 x (2 mamba, the shared
# attention block) plus a 1-layer mamba tail — the full config's layout
SSM_ARCHS = ["mamba2-2.7b", "zamba2-7b"]


@functools.lru_cache(maxsize=None)
def _ssm(arch, use_kernels=False):
    """(port cfg, JAX model, JAX params, numpy tree).  The JAX model with
    ``use_kernels`` takes its "jnp" kernel oracles, so its SSD gate runs
    the sequential ``ssd_ref`` — the route the port's kernel gate takes
    on the CPU; without, both take the chunked ``ssd_scan``."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    jm = jax_build(jcfg, use_kernels=use_kernels)
    jp = jm.init(jax.random.key(4))
    return cfg, jm, jp, jax.tree.map(np.asarray, jp)


def _ssm_port(arch, use_kernels=False):
    cfg, _, _, tree = _ssm(arch)
    m = Model(cfg, device="cpu", use_kernels=use_kernels)
    m.load_state_dict(params_from_jax(tree, cfg))
    return m


def _jax_layer_caches(jm, caches):
    """The JAX cache tree of prefill or chunk_step as one entry per
    layer in execution order: ``(conv_x, conv_bc, ssm)`` for a Mamba-2
    layer, the attention dict for a shared-attention one."""
    out = []
    for spec, c in zip(jm.segments, caches):
        inner = spec.inner if spec.kind == "group" else ((spec.kind,
                                                          spec.count),)
        for g in range(spec.count if spec.kind == "group" else 1):
            for kind, count in inner:
                sub = c[kind] if spec.kind == "group" else c
                pick = ((lambda a, j, g=g: a[g, j]) if spec.kind == "group"
                        else (lambda a, j: a[j]))
                if kind == "mamba":
                    out += [(np.asarray(pick(sub["conv"]["x"], j)),
                             np.asarray(pick(sub["conv"]["bc"], j)),
                             np.asarray(pick(sub["ssm"], j)))
                            for j in range(count)]
                else:
                    out.append(jax.tree.map(
                        lambda a, g=g: np.asarray(a[g]), sub))
    return out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_params_from_jax_maps_ssm_and_hybrid_layers(arch):
    """Every leaf used exactly once: a Mamba-2 leaf fans out to its
    layers (zamba2's ``(n_groups, 2, ...)`` group leaves in execution
    order), the shared block's leaves to ``shared.…`` once."""
    cfg, jm, _, tree = _ssm(arch)
    model = _ssm_port(arch)
    sd = params_from_jax(tree, cfg)
    assert set(sd) == set(model.state_dict())
    segs = tree["segments"]
    mamba_at = [i for i, k in enumerate(model.kinds) if k == "mamba"]
    w_x = lambda i: model.layers[i].mamba["w_x"].numpy()  # noqa: E731
    if arch == "mamba2-2.7b":
        assert model.kinds == ["mamba"] * 2 and model.shared is None
        np.testing.assert_array_equal(w_x(1), segs[0]["mamba"]["w_x"][1])
        np.testing.assert_array_equal(model.layers[0].ln.numpy(),
                                      segs[0]["ln"][0])
    else:
        assert model.kinds == ["mamba", "mamba", "shared_attn"] * 2 + [
            "mamba"]
        assert jm.segments[0].kind == "group"
        grp = segs[0]["mamba"]["mamba"]["w_x"]          # (2 groups, 2, ...)
        np.testing.assert_array_equal(w_x(1), grp[0, 1])
        np.testing.assert_array_equal(w_x(3), grp[1, 0])
        np.testing.assert_array_equal(w_x(6), segs[1]["mamba"]["w_x"][0])
        np.testing.assert_array_equal(model.shared.attn["wq"].numpy(),
                                      tree["shared"]["attn"]["wq"])
        assert [model.cache_row[i] for i in mamba_at] == list(range(5))
        assert [model.cache_row[i] for i in (2, 5)] == [0, 1]
    assert (model.head is None) is cfg.tie_embeddings  # tied: embed.T


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_full_width_ssm_and_hybrid_layouts_map_from_shapes(arch):
    """At full width (64 Mamba-2 layers; 13 x (5 mamba + shared) + 3)
    the JAX tree's shapes (``jax.eval_shape``, nothing materialized)
    map onto the port's parameters one for one, shape for shape, and
    count ``cfg.param_count()``."""
    from repro.configs import get_config as jax_config
    cfg = get_config(arch)
    tree = jax.eval_shape(jax_build(jax_config(arch)).init,
                          jax.random.key(0))
    shapes = param_shapes_from_jax(tree, cfg)
    model = Model(cfg, device="meta")
    assert shapes == {k: tuple(v.shape)
                      for k, v in model.state_dict().items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg.param_count()
    n_mamba = {"mamba2-2.7b": 64, "zamba2-7b": 68}[arch]
    assert model.n_mamba == n_mamba
    assert model.n_attn == cfg.n_layers - n_mamba


@functools.lru_cache(maxsize=None)
def _ssm_jax_run(arch, use_kernels, n_decode=8):
    """JAX prefill of three right-padded prompts padded to 16 (the SSM
    chunk, so the kernel gate holds), then ``n_decode`` greedy decode
    steps: the inputs, logits and layer caches of every step."""
    _, jm, jp, _ = _ssm(arch, use_kernels)
    rng = np.random.default_rng(6)
    lens = np.array([16, 9, 3], np.int32)
    toks = rng.integers(0, 256, (3, 16)).astype(np.int32)
    lj, jc = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, jnp.asarray(toks), jnp.asarray(lens), cache_len=32)
    steps = [(toks, lens, np.asarray(lj), _jax_layer_caches(jm, jc))]
    pos, last = lens.copy(), np.asarray(lj).argmax(-1).astype(np.int32)
    step = jax.jit(jm.decode_step)
    for _ in range(n_decode):
        lj, jc = step(jp, jc, jnp.asarray(last), jnp.asarray(pos))
        steps.append((last, pos, np.asarray(lj), _jax_layer_caches(jm, jc)))
        last, pos = np.asarray(lj).argmax(-1).astype(np.int32), pos + 1
    return steps


def _assert_caches_match(port_caches, jax_caches, kinds):
    for kind, got, want in zip(kinds, port_caches, jax_caches):
        if kind == "mamba":
            for name, w in zip(("conv_x", "conv_bc", "ssm"), want):
                np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                           atol=1e-4)
        else:
            for name in ("k", "v"):
                np.testing.assert_allclose(got[name].numpy(), want[name],
                                           rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_prefill_and_decode_match_jax(arch, use_kernels):
    """Right-padded prompts (16, 9, 3 tokens): prefill logits and every
    layer's cache (conv histories and SSM state at each row's true end;
    the shared block's K/V at each invocation), then 8 decode steps,
    within 1e-4.  ``use_kernels`` takes the SSD kernel's gate (the
    sequential ``ssd_ref`` on the CPU, held to the JAX model's
    ``use_kernels`` route) or the chunked ``ssd_scan``."""
    steps = _ssm_jax_run(arch, use_kernels)
    model = _ssm_port(arch, use_kernels)
    (toks, lens, want, want_c), rest = steps[0], steps[1:]
    got, caches = model.prefill(torch.as_tensor(toks), torch.as_tensor(lens),
                                cache_len=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    _assert_caches_match(caches, want_c, model.kinds)
    for last, pos, want, want_c in rest:
        got, caches = model.decode_step(caches, torch.as_tensor(last),
                                        torch.as_tensor(pos))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    _assert_caches_match(caches, want_c, model.kinds)


def test_ssm_kernel_gate_mirrors_jax_on_mamba2(monkeypatch):
    """The SSD kernel runs where the JAX package runs its Pallas kernel:
    a prefill whose length is a multiple of the chunk, with no carried
    state — never on a ragged length, in chunked prefill or in decode."""
    from repro_torch.kernels import ref
    calls = []
    real = ref.ssd_ref
    monkeypatch.setattr(ref, "ssd_ref",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    model = _ssm_port("mamba2-2.7b", use_kernels=True)
    toks = torch.zeros((2, 16), dtype=torch.int32)
    lens = torch.tensor([16, 5], dtype=torch.int32)
    _, caches = model.prefill(toks, lens)
    assert len(calls) == 2                       # S = 16 = chunk: each layer
    model.prefill(toks[:, :12], torch.tensor([12, 5], dtype=torch.int32))
    model.decode_step(caches, toks[:, 0], lens)
    kv = PagedKVManager(2, 32, 4, device="cpu")
    model.chunk_step(model.init_paged_cache(2, 32, 4), torch.as_tensor(
        kv.table), toks, torch.zeros(2, dtype=torch.int32), lens)
    assert len(calls) == 2
    model.use_kernels = False
    model.prefill(toks, lens)
    assert len(calls) == 2


@pytest.mark.parametrize("chunk", [3, 8])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_chunked_prefill_matches_monolithic_and_jax(arch, chunk):
    """Prefilling 13 tokens in chunks through the paged plane (SSM state
    carried in slot rows, the shared block's K/V in pages) reproduces
    monolithic prefill's last-token logits (mirrors
    tests/test_decode_consistency.py), and each chunk's logits and the
    final slot-row state equal the JAX model's, within 1e-4; a row of
    chunk length 0 keeps its state exactly."""
    cfg, jm, jp, _ = _ssm(arch)
    model = _ssm_port(arch)
    b, s, max_len, ps = 3, 13, 32, 4
    toks = np.random.default_rng(chunk).integers(0, 256, (b, s)).astype(
        np.int32)
    lens = np.array([s, s, 0], np.int32)          # row 2 idles
    want, _ = model.prefill(torch.as_tensor(toks[:2]),
                            torch.as_tensor(lens[:2]), cache_len=max_len)
    kv = PagedKVManager(b, max_len, ps, device="cpu")
    for i in range(2):
        assert kv.ensure(i, s)
    jc = jm.init_paged_cache(b, max_len, ps, kv.n_pages)
    tc = model.init_paged_cache(b, max_len, ps, kv.n_pages)
    state = tc[-1]
    state["ssm"][:, 2] = 0.5                      # the idle row's state
    jstep = jax.jit(jm.chunk_step)
    for start in range(0, s, chunk):
        c = min(chunk, s - start)
        tk = np.zeros((b, chunk), np.int32)
        tk[:, :c] = toks[:, start:start + c]
        args = (kv.table, tk, np.full(b, start, np.int32),
                np.where(lens > 0, c, 0).astype(np.int32))
        lj, jc = jstep(jp, jc, *map(jnp.asarray, args))
        lt, tc = model.chunk_step(tc, *map(torch.as_tensor, args))
        np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lt.numpy()[:2], want.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert (state["ssm"][:, 2] == 0.5).all()
    assert not state["conv_x"][:, 2].any()
    layer = _jax_layer_caches(jm, jc)
    rows = [i for i, k in enumerate(model.kinds) if k == "mamba"]
    for r, i in enumerate(rows):
        for name, w in zip(("conv_x", "conv_bc", "ssm"), layer[i]):
            np.testing.assert_allclose(state[name][r, :2].numpy(), w[:2],
                                       rtol=1e-4, atol=1e-4)
