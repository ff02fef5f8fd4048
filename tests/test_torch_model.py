"""Model of the PyTorch port against the JAX ``Model`` on the same
weights: parameter conversion, ``chunk_step`` logits, ``decode_block``
tokens and stopping, and the capability refusals.

f32 on the CPU.  Logits tolerance 1e-4: the two frameworks sum the
same f32 products in another order, through 2 layers and a 256-way
head.
"""

import dataclasses

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
from repro_torch.models.convert import params_from_jax  # noqa: E402
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


def _run_both(ps, chunks, n_decode):
    """Drive both models through the same chunked prefill and C == 1
    decode steps; return the per-step logits of each."""
    b, max_len = 3, 32
    rng = np.random.default_rng(ps)
    kv = PagedKVManager(b, max_len, ps)
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
        kv = PagedKVManager(b, max_len, ps)
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
    """Where the JAX Model supports the paged plane, so does the port;
    where it refuses (sliding windows, SSM), the port refuses to build
    the model at all until those ROADMAP items land."""
    model = _port_model()
    for flag in ("supports_chunked", "supports_prefix_cache",
                 "supports_spec_decode"):
        assert getattr(model, flag) is getattr(JMODEL, flag) is True
    for arch in ("gemma3-4b", "mamba2-2.7b", "olmoe-1b-7b"):
        jcfg = jax_smoke(arch)
        fields = {f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(ModelConfig)}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(ModelConfig(**fields), device="cpu")
    assert not jax_build(jax_smoke("gemma3-4b")).supports_chunked
    assert not jax_build(jax_smoke("mamba2-2.7b")).supports_prefix_cache
