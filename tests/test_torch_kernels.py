"""Kernels of the PyTorch port: the plain versions against the JAX
package (its jnp oracles and its Pallas kernels in interpret mode), the
wrappers' refusals, and — on a CUDA card only — each CUDA kernel against
its plain version.

Inputs are drawn with numpy from a seed and fed to both packages.
Tolerance 2e-5 in f32 (the JAX package's own kernel tolerance: f32
sums taken in another order); 2e-2 in bf16 on the card (bf16 keeps
about three significant digits).  JAX is imported inside the tests that
compare with it, so the card-only tests also run where JAX is absent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, decode_attention, ops, ref  # noqa: E402,E501
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import page_gather as gather_mod  # noqa: E402
from repro_torch.serving.kv_manager import PagedKVManager  # noqa: E402

TOL = 2e-5


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import paged_decode_attention
    from repro.kernels.page_gather import page_gather
    return jnp, jref, paged_decode_attention, page_gather


def _paged_fixture(seed, b, h, s, d, ps, *, zero_row=False):
    """A contiguous cache and its paged twin laid out by the port's
    PagedKVManager (numpy; mirrors tests/test_paged_kv.py)."""
    rng = np.random.default_rng(seed)
    kv = PagedKVManager(n_slots=b, max_len=s, page_size=ps)
    kv_len = rng.integers(1, s + 1, size=b).astype(np.int32)
    if zero_row:
        kv_len[0] = 0
    k_cont = rng.standard_normal((b, h, s, d)).astype(np.float32)
    v_cont = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k_pages = np.zeros((kv.n_pages, h, ps, d), np.float32)
    v_pages = np.zeros((kv.n_pages, h, ps, d), np.float32)
    for i in range(b):
        assert kv.ensure(i, int(kv_len[i]))
        for t in range(int(kv_len[i])):
            pg = kv.table[i, t // ps]
            k_pages[pg, :, t % ps] = k_cont[i, :, t]
            v_pages[pg, :, t % ps] = v_cont[i, :, t]
        k_cont[i, :, kv_len[i]:] = 0
        v_cont[i, :, kv_len[i]:] = 0
    return kv.table.copy(), k_cont, v_cont, k_pages, v_pages, kv_len


def _poison(table, k_pages, v_pages, kv_len, ps):
    """Fill every allocated-but-unused offset and every free page with
    1e3 (stale data of reclaimed pages must never leak in)."""
    mask = np.zeros((k_pages.shape[0], 1, ps, 1), bool)
    for i in range(table.shape[0]):
        for t in range(int(kv_len[i])):
            mask[table[i, t // ps], 0, t % ps, 0] = True
    return (np.where(mask, k_pages, 1e3).astype(np.float32),
            np.where(mask, v_pages, 1e3).astype(np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Plain versions vs the JAX package (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ps", [4, 8, 16])
def test_paged_decode_attention_plain_matches_jax(ps):
    jnp, jref, pl_paged, _ = _jax()
    b, h, s, d = 3, 2, 32, 16
    table, k_cont, v_cont, k_pages, v_pages, kv_len = _paged_fixture(
        ps, b, h, s, d, ps)
    q = np.random.default_rng(7).standard_normal((b, h, d)).astype(np.float32)
    got = ref.paged_decode_attention_ref(
        *_t(q, k_pages, v_pages, table, kv_len))
    want = jref.decode_attention_ref(*map(jnp.asarray,
                                          (q, k_cont, v_cont, kv_len)))
    pallas = pl_paged(*map(jnp.asarray, (q, k_pages, v_pages, table,
                                         kv_len)), interpret=True)
    _close(got, want)
    _close(got, pallas)


def test_paged_decode_attention_plain_gqa_matches_jax():
    """Hq=6 over Hkv=2: query head hi reads kv head hi // 3."""
    jnp, jref, pl_paged, _ = _jax()
    b, hq, hkv, s, d, ps = 2, 6, 2, 16, 16, 4
    table, _, _, k_pages, v_pages, kv_len = _paged_fixture(
        11, b, hkv, s, d, ps)
    q = np.random.default_rng(5).standard_normal((b, hq, d)).astype(
        np.float32)
    got = ref.paged_decode_attention_ref(
        *_t(q, k_pages, v_pages, table, kv_len))
    args = map(jnp.asarray, (q, k_pages, v_pages, table, kv_len))
    args = list(args)
    _close(got, jref.paged_decode_attention_ref(*args))
    _close(got, pl_paged(*args, interpret=True))


def test_paged_decode_attention_plain_ignores_stale_pages():
    jnp, jref, pl_paged, _ = _jax()
    b, h, s, d, ps = 2, 2, 16, 8, 4
    table, k_cont, v_cont, k_pages, v_pages, kv_len = _paged_fixture(
        3, b, h, s, d, ps)
    k_pois, v_pois = _poison(table, k_pages, v_pages, kv_len, ps)
    q = np.random.default_rng(9).standard_normal((b, h, d)).astype(np.float32)
    got = ref.paged_decode_attention_ref(
        *_t(q, k_pois, v_pois, table, kv_len))
    want = jref.decode_attention_ref(*map(jnp.asarray,
                                          (q, k_cont, v_cont, kv_len)))
    pallas = pl_paged(*map(jnp.asarray, (q, k_pois, v_pois, table, kv_len)),
                      interpret=True)
    _close(got, want)
    _close(got, pallas)


def test_paged_decode_attention_kv_len_zero_gives_zeros():
    """A row with kv_len == 0: the Pallas kernel returns zeros (its
    running sum stays 0), the JAX oracle returns the mean of page 0's V.
    The port's plain version follows the kernel, with no NaN."""
    jnp, jref, pl_paged, _ = _jax()
    b, h, s, d, ps = 2, 2, 16, 8, 4   # the stale-page test's shape
    table, _, _, k_pages, v_pages, kv_len = _paged_fixture(
        21, b, h, s, d, ps, zero_row=True)
    q = np.random.default_rng(2).standard_normal((b, h, d)).astype(np.float32)
    got = ref.paged_decode_attention_ref(
        *_t(q, k_pages, v_pages, table, kv_len)).numpy()
    pallas = np.asarray(pl_paged(
        *map(jnp.asarray, (q, k_pages, v_pages, table, kv_len)),
        interpret=True))
    assert not np.isnan(got).any()
    assert (got[0] == 0).all() and (pallas[0] == 0).all()
    _close(got, pallas)


def test_decode_attention_plain_matches_jax():
    jnp, jref, _, _ = _jax()
    rng = np.random.default_rng(4)
    b, h, s, d = 3, 2, 24, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kv_len = np.array([24, 7, 1], np.int32)
    _close(ref.decode_attention_ref(*_t(q, k, v, kv_len)),
           jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, kv_len))))


def _attn_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_attention_plain_matches_jax(causal, window):
    """GQA 4/2 by index in the port; the JAX oracle and the Pallas
    kernel (interpret mode) get K/V repeated to Hq, as the JAX model
    feeds them."""
    jnp, jref, _, _ = _jax()
    from repro.kernels.flash_attention import flash_attention as pl_flash
    q, k, v = _attn_inputs(int(causal) + window, 2, 4, 2, 128, 16)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=causal, window=window)
    kr, vr = (jnp.repeat(jnp.asarray(a), 2, axis=1) for a in (k, v))
    want = jref.flash_attention_ref(jnp.asarray(q), kr, vr, causal=causal,
                                    window=window)
    pallas = pl_flash(jnp.asarray(q), kr, vr, causal=causal, window=window,
                      block_q=64, block_k=64, interpret=True)
    _close(got, want)
    _close(got, pallas)


def test_decode_attention_plain_gqa_matches_jax_and_pallas():
    """GQA 4/2 by index, and kv_len == 0 gives zeros, as the Pallas
    kernel does (the JAX oracle returns the mean of V there)."""
    jnp, jref, _, _ = _jax()
    from repro.kernels.decode_attention import decode_attention as pl_decode
    rng = np.random.default_rng(6)
    b, hq, hkv, s, d = 4, 4, 2, 256, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    kv_len = np.array([256, 37, 0, 1], np.int32)
    got = ref.decode_attention_ref(*_t(q, k, v, kv_len)).numpy()
    kr, vr = (jnp.repeat(jnp.asarray(a), 2, axis=1) for a in (k, v))
    args = (jnp.asarray(q), kr, vr, jnp.asarray(kv_len))
    want = np.asarray(jref.decode_attention_ref(*args))
    pallas = np.asarray(pl_decode(*args, interpret=True))
    live = kv_len > 0
    _close(got[live], want[live])
    _close(got, pallas)
    assert (got[2] == 0).all() and (pallas[2] == 0).all()
    assert not np.isnan(got).any()


def test_paged_gather_plain_matches_jax():
    jnp, jref, _, _ = _jax()
    b, h, s, d, ps = 3, 2, 32, 16, 8
    table, _, _, k_pages, _, _ = _paged_fixture(0, b, h, s, d, ps)
    got = ref.paged_gather(*_t(k_pages, table))
    want = jref.paged_gather(jnp.asarray(k_pages), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ps", [4, 8])
def test_page_gather_plain_matches_jax(ps):
    """All layers in one call; -1 ids clamp to page 0 like the JAX
    oracle and the Pallas kernel (vmapped over layers)."""
    jax = pytest.importorskip("jax")
    jnp, jref, _, pl_gather = _jax()
    rng = np.random.default_rng(ps)
    n_l, n_pages, h, d = 3, 6, 2, 8
    pages = rng.standard_normal((n_l, n_pages, h, ps, d)).astype(np.float32)
    ids = np.array([4, 1, -1, 5, -1], np.int32)
    got = ref.page_gather_ref(*_t(pages, ids)).numpy()
    want = jax.vmap(lambda p: jref.page_gather_ref(p, jnp.asarray(ids)))(
        jnp.asarray(pages))
    pallas = jax.vmap(lambda p: pl_gather(p, jnp.asarray(ids),
                                          interpret=True))(jnp.asarray(pages))
    assert got.shape == (n_l, h, len(ids) * ps, d)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got[:, :, 2 * ps:3 * ps], pages[:, 0])


# ---------------------------------------------------------------------------
# Dispatch and wrapper refusals (CPU)
# ---------------------------------------------------------------------------


def test_ops_send_cpu_tensors_to_the_plain_versions():
    table, _, _, k_pages, v_pages, kv_len = _paged_fixture(1, 2, 2, 16, 8, 4)
    q = torch.randn(2, 2, 8, generator=torch.Generator().manual_seed(0))
    before = ops.launch_counts()
    qf, kf, vf = _t(*_attn_inputs(0, 1, 4, 2, 40, 16))
    torch.testing.assert_close(
        ops.flash_attention(qf, kf, vf, causal=True, window=8),
        ref.flash_attention_ref(qf, kf, vf, causal=True, window=8),
        rtol=0, atol=0)
    lens = torch.tensor([17], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention(qf[:, :, 0], kf, vf, lens),
        ref.decode_attention_ref(qf[:, :, 0], kf, vf, lens), rtol=0, atol=0)
    out = ops.paged_decode_attention(q, *_t(k_pages, v_pages, table, kv_len))
    torch.testing.assert_close(out, ref.paged_decode_attention_ref(
        q, *_t(k_pages, v_pages, table, kv_len)), rtol=0, atol=0)
    pages = torch.as_tensor(k_pages)[None]
    ids = torch.tensor([1, -1], dtype=torch.int32)
    assert torch.equal(ops.page_gather(pages, ids),
                       ref.page_gather_ref(pages, ids))
    assert ops.launch_counts() == before  # no kernel ran


@pytest.mark.parametrize("err,counted", [(0, 1), (700, 0)])
def test_launch_counts_only_a_launch_the_entry_point_reports(monkeypatch,
                                                             err, counted):
    """The count goes up where the kernel is launched and only when the C
    entry point returns cudaSuccess; a failed launch raises and counts
    nothing."""
    calls = []

    class FakeLib:
        def paged_decode_attention_launch(self, *args):
            calls.append(args)
            return err

    monkeypatch.setattr(_build, "library", lambda name: FakeLib())
    ops.reset_launch_counts()
    if err:
        with pytest.raises(RuntimeError, match=f"cudaError_t {err}"):
            _build.launch("paged_decode_attention", 1, 2)
    else:
        _build.launch("paged_decode_attention", 1, 2)
    assert calls == [(1, 2)]
    assert ops.launch_counts() == {"paged_decode_attention": counted,
                                   "page_gather": 0, "flash_attention": 0,
                                   "decode_attention": 0}
    ops.reset_launch_counts()


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises — it never computes on
    the CPU in the kernel's place."""
    table, _, _, k_pages, v_pages, kv_len = _paged_fixture(1, 2, 2, 16, 8, 4)
    q = torch.zeros(2, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.paged_decode_attention(
            q, *_t(k_pages, v_pages, table, kv_len))
    with pytest.raises(ValueError, match="CUDA"):
        gather_mod.page_gather(torch.zeros(1, 2, 2, 4, 8),
                               torch.zeros(2, dtype=torch.int32))
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention(x[:, :, 0], x, x,
                                          torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,d,ps", [
    (3, 2, 2, 16, 4), (3, 2, 2, 8, 8), (2, 6, 2, 16, 4), (4, 4, 4, 128, 16),
    (2, 40, 8, 128, 16), (2, 4, 4, 64, 16), (3, 4, 2, 64, 80),
    (2, 8, 4, 128, 48),
])
def test_paged_decode_attention_kernel_matches_plain(cuda, dtype, b, hq,
                                                     hkv, d, ps):
    """GQA, poisoned stale offsets, a kv_len == 0 row; the last two
    cases hold 640 and 384 positions a row, so the split-KV grid cuts
    them into chunks of 214 and 192 that do not end on a page."""
    dt = getattr(torch, dtype)
    s = 8 * ps
    table, _, _, k_pages, v_pages, kv_len = _paged_fixture(
        d + ps, b, hkv, s, d, ps, zero_row=True)
    k_pages, v_pages = _poison(table, k_pages, v_pages, kv_len, ps)
    q = np.random.default_rng(d).standard_normal((b, hq, d))
    q, k_pages, v_pages = (torch.as_tensor(a).to(cuda, dt)
                           for a in (q, k_pages, v_pages))
    table, kv_len = (torch.as_tensor(a).to(cuda) for a in (table, kv_len))
    got = decode_attention.paged_decode_attention(q, k_pages, v_pages, table,
                                                  kv_len)
    want = ref.paged_decode_attention_ref(q, k_pages, v_pages, table, kv_len)
    torch.cuda.synchronize()
    tol = TOL if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (got[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_gather_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    pages = torch.randn(3, 9, 2, 4, 16, generator=g, device=cuda).to(
        getattr(torch, dtype))
    ids = torch.tensor([7, -1, 0, 3, -1, 8], dtype=torch.int32, device=cuda)
    got = gather_mod.page_gather(pages, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.page_gather_ref(pages, ids))


@pytest.mark.cuda
def test_empty_calls_launch_nothing_and_count_nothing(cuda):
    pages = torch.zeros(4, 2, 4, 16, device=cuda)
    table = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    kv_len = torch.ones(2, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    out = decode_attention.paged_decode_attention(
        torch.zeros(0, 2, 16, device=cuda), pages, pages, table[:0],
        kv_len[:0])
    assert out.shape == (0, 2, 16)
    out = gather_mod.page_gather(pages[None],
                                 torch.zeros(0, dtype=torch.int32,
                                             device=cuda))
    assert out.shape == (1, 2, 0, 16)
    assert set(ops.launch_counts().values()) == {0}
    decode_attention.paged_decode_attention(
        torch.zeros(2, 2, 16, device=cuda), pages, pages, table, kv_len)
    gather_mod.page_gather(pages[None], table[0])
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"paged_decode_attention": 1,
                                   "page_gather": 1, "flash_attention": 0,
                                   "decode_attention": 0}


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 2, 16, device=cuda)
    pages = torch.zeros(4, 2, 4, 16, device=cuda)
    table = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    kv_len = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):   # torch's default integer is int64
        decode_attention.paged_decode_attention(q, pages, pages,
                                                table.long(), kv_len)
    with pytest.raises(ValueError):  # a strided view, not contiguous
        decode_attention.paged_decode_attention(
            torch.zeros(2, 2, 2, 16, device=cuda)[:, :, 0, :].transpose(0, 1),
            pages, pages, table, kv_len)
    with pytest.raises(ValueError):  # head_dim the kernel has no case for
        decode_attention.paged_decode_attention(
            torch.zeros(2, 2, 12, device=cuda),
            torch.zeros(4, 2, 4, 12, device=cuda),
            torch.zeros(4, 2, 4, 12, device=cuda), table, kv_len)


def _card_attn(cuda, seed, b, hq, hkv, s, d, dt):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dt)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (2, 4, 2, 128, 16, True, 0), (1, 2, 2, 40, 32, True, 0),
    (2, 2, 1, 200, 64, False, 0), (1, 4, 4, 130, 128, True, 48),
    (2, 8, 4, 8, 256, True, 0), (1, 8, 4, 300, 256, True, 100),
    (1, 2, 2, 64, 64, False, 16),
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, hq, hkv, s, d,
                                              causal, window):
    """Ragged S (not a multiple of the 64-row tile), GQA, causal,
    windowed and bidirectional, D from 16 to 256."""
    dt = getattr(torch, dtype)
    q, k, v = _card_attn(cuda, s + d, b, hq, hkv, s, d, dt)
    got = flash_mod.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = TOL if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (3, 4, 2, 24, 16), (4, 8, 4, 600, 256), (3, 4, 4, 513, 128),
    (2, 6, 2, 40, 64),
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, b, hq, hkv, s, d):
    """Any S (split over blocks of 256 positions), GQA, and a kv_len == 0
    row that must come back as zeros."""
    dt = getattr(torch, dtype)
    q, k, v = _card_attn(cuda, s, b, hq, hkv, s, d, dt)
    q = q[:, :, 0].contiguous()
    kv_len = torch.as_tensor(
        np.random.default_rng(s).integers(1, s + 1, size=b).astype(np.int32),
        device=cuda)
    kv_len[0] = 0
    got = decode_attention.decode_attention(q, k, v, kv_len)
    want = ref.decode_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    tol = TOL if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (got[0] == 0).all()
