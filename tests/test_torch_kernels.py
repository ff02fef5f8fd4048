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
from repro_torch.kernels import rmsnorm as rmsnorm_mod  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
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
    kv = PagedKVManager(n_slots=b, max_len=s, page_size=ps, device="cpu")
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


def _ssd_inputs(seed, b, s, h, p, n, *, lens=None):
    """SSD operands drawn as tests/test_kernels.py draws them (x, B, C
    normal; dt softplus of a normal; a = -exp(0.5 * normal)); with
    ``lens``, dt is 0 past each row's length, as the model pads it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    if lens is not None:
        dt[np.arange(s)[None, :] >= np.asarray(lens)[:, None]] = 0.0
    return x, dt, a, bm, cm


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


@pytest.mark.parametrize("s,h,p,n,chunk", [
    (128, 2, 16, 32, 32), (256, 4, 16, 32, 64), (256, 4, 32, 64, 128),
])
def test_ssd_plain_matches_jax(s, h, p, n, chunk):
    """The port's sequential ``ssd_ref`` against the JAX oracle and the
    Pallas kernel (interpret mode) at tests/test_kernels.py's shapes,
    rtol = atol = 2e-3 (chunked against sequential f32 sums, the JAX
    package's own criterion)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.ssd import ssd as pl_ssd
    args = _ssd_inputs(s + h, 2, s, h, p, n)
    y, state = ref.ssd_ref(*_t(*args))
    jargs = list(map(jnp.asarray, args))
    for y_j, state_j in (jref.ssd_ref(*jargs),
                         pl_ssd(*jargs, chunk=chunk, interpret=True)):
        _close(y, y_j, 2e-3)
        _close(state, state_j, 2e-3)


@pytest.mark.parametrize("case", ["init_state", "padded", "groups"])
def test_ssd_scan_matches_jax(case):
    """The model's plain chunked scan against the JAX package's, 1e-4
    (the same chunked f32 algorithm): a carried initial state (chunked
    prefill), S not a multiple of the chunk (padded inside), and G = 2
    B/C groups over 4 heads; without a carried state it also agrees with
    the sequential oracle within 2e-3."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import mamba2 as jmamba
    from repro_torch.models import mamba2
    b, s, h, p, n, g, chunk = 2, 48, 4, 8, 16, 1, 16
    if case == "padded":
        s = 37
    if case == "groups":
        g = 2
    rng = np.random.default_rng(len(case))
    x, dt, a, _, _ = _ssd_inputs(len(case), b, s, h, p, n)
    bm, cm = (rng.standard_normal((b, s, g, n)).astype(np.float32)
              for _ in range(2))
    init = (rng.standard_normal((b, h, p, n)).astype(np.float32)
            if case == "init_state" else None)
    got = mamba2.ssd_scan(*_t(x, dt, a, bm, cm), chunk=chunk,
                          init_state=None if init is None
                          else torch.as_tensor(init))
    want = jmamba.ssd_scan(*map(jnp.asarray, (x, dt, a, bm, cm)),
                           chunk=chunk,
                           init_state=None if init is None
                           else jnp.asarray(init))
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)
    if case == "padded":
        seq = ref.ssd_ref(*_t(x, dt, a, bm[:, :, 0], cm[:, :, 0]))
        _close(got[0], seq[0], 2e-3)
        _close(got[1], seq[1], 2e-3)


@pytest.mark.parametrize("s,h,p,n,chunk", [
    (64, 3, 8, 16, 16),                # the smoke configs' SSM
    (128, 2, 16, 32, 32), (256, 4, 16, 32, 64),
    (256, 4, 32, 64, 128),             # tests/test_kernels.py's sweep
])
def test_ssd_tensor_core_passes_match_jax(s, h, p, n, chunk):
    """The tensor-core SSD's two passes, written plainly (C B^T once per
    64-row chunk for all heads, then the chunks in sequence), composed
    and held against the JAX package's SSD kernel (Pallas, interpret
    mode, at its own chunk) and its sequential oracle: f32, pad rows
    (dt = 0 past each row's length), rtol = atol = 1e-4."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.ssd import ssd as pl_ssd
    args = _ssd_inputs(s + n, 2, s, h, p, n, lens=[s, s // 2 + 3])
    x, dt, a, bm, cm = _t(*args)
    cb = ref.ssd_chunk_cb_ref(bm, cm, 64)
    assert cb.shape == (2, s // 64, 64, 64)
    y, state = ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, cb, chunk=64)
    jargs = list(map(jnp.asarray, args))
    for y_j, state_j in (pl_ssd(*jargs, chunk=chunk, interpret=True),
                         jref.ssd_ref(*jargs)):
        _close(y, y_j, 1e-4)
        _close(state, state_j, 1e-4)


def test_ssd_tensor_core_gate():
    """bf16 at mamba2's and zamba2's (head_dim, d_state) with S a
    multiple of 64 takes the tensor-core instance; f32, the smoke and
    test shapes and a ragged S take the CUDA-core one."""
    def x(dtype, s, p):
        return torch.zeros(1, s, 2, p, dtype=dtype)
    bf16, f32 = torch.bfloat16, torch.float32
    assert ssd_mod.uses_tensor_cores(x(bf16, 512, 64), 128)
    assert ssd_mod.uses_tensor_cores(x(bf16, 64, 64), 64)
    assert not ssd_mod.uses_tensor_cores(x(f32, 512, 64), 128)
    assert not ssd_mod.uses_tensor_cores(x(bf16, 96, 64), 128)
    assert not ssd_mod.uses_tensor_cores(x(bf16, 64, 8), 16)
    assert not ssd_mod.uses_tensor_cores(x(bf16, 256, 32), 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,br", [(128, 64, 32), (256, 512, 256),
                                       (64, 128, 64)])
def test_rmsnorm_plain_matches_jax(rows, d, br, dtype):
    """The port's ``rmsnorm_ref`` against the JAX oracle and the Pallas
    kernel (interpret mode) at tests/test_kernels.py's shapes; 2e-5 in
    f32, 2e-2 in bf16 (the JAX package's tolerances)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.rmsnorm import rmsnorm as pl_rmsnorm
    rng = np.random.default_rng(rows + d)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    sc = (0.1 * rng.standard_normal(d)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    got = ref.rmsnorm_ref(xt, torch.as_tensor(sc)).float().numpy()
    tol = TOL if dtype == "float32" else 2e-2
    for want in (jref.rmsnorm_ref(xj, jnp.asarray(sc)),
                 pl_rmsnorm(xj, jnp.asarray(sc), block_rows=br,
                            interpret=True)):
        _close(got, np.asarray(want, np.float32), tol)


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
    sargs = _t(*_ssd_inputs(2, 2, 32, 2, 8, 16))
    for got, want in zip(ops.ssd(*sargs, chunk=16), ref.ssd_ref(*sargs)):
        assert torch.equal(got, want)
    xr, sc = torch.randn(3, 8), torch.randn(8)
    assert torch.equal(ops.rmsnorm(xr, sc), ref.rmsnorm_ref(xr, sc))
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
                                   "decode_attention": 0, "ssd": 0,
                                   "rmsnorm": 0}
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
    xs, dt, a, bm, cm = _t(*_ssd_inputs(0, 1, 32, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd(xs, dt, a, bm, cm, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_mod.rmsnorm(torch.zeros(2, 8), torch.zeros(8))


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
    (2, 8, 4, 128, 48), (2, 4, 4, 112, 16),
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
    y, st = ssd_mod.ssd(torch.zeros(0, 32, 2, 8, device=cuda),
                        torch.zeros(0, 32, 2, device=cuda),
                        torch.zeros(2, device=cuda),
                        torch.zeros(0, 32, 16, device=cuda),
                        torch.zeros(0, 32, 16, device=cuda), chunk=16)
    assert y.shape == (0, 32, 2, 8) and st.shape == (0, 2, 8, 16)
    out = rmsnorm_mod.rmsnorm(torch.zeros(0, 8, device=cuda),
                              torch.zeros(8, device=cuda))
    assert out.shape == (0, 8)
    assert set(ops.launch_counts().values()) == {0}
    decode_attention.paged_decode_attention(
        torch.zeros(2, 2, 16, device=cuda), pages, pages, table, kv_len)
    gather_mod.page_gather(pages[None], table[0])
    ssd_mod.ssd(*(torch.as_tensor(v).to(cuda)
                  for v in _ssd_inputs(0, 1, 32, 2, 8, 16)), chunk=16)
    rmsnorm_mod.rmsnorm(torch.ones(3, 8, device=cuda),
                        torch.zeros(8, device=cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"paged_decode_attention": 1,
                                   "page_gather": 1, "flash_attention": 0,
                                   "decode_attention": 0, "ssd": 1,
                                   "rmsnorm": 1}


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
    (1, 2, 2, 64, 64, False, 16), (1, 4, 4, 130, 112, True, 0),
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
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 8, 4, 2048, 256, True, 1024),   # gemma3's local layer
    (2, 8, 4, 1100, 256, True, 0),      # gemma3's global layer, ragged S
    (2, 8, 4, 40, 256, True, 64),       # one ragged tile
    (1, 4, 4, 1100, 128, True, 64),     # qwen7b's heads, a narrow window
    (2, 4, 4, 40, 128, False, 0),
    (1, 4, 2, 1100, 112, False, 0),     # zamba2's head dim
    (1, 4, 4, 2048, 112, True, 1024),
    (2, 4, 4, 40, 112, True, 0),
    (1, 8, 4, 300, 64, True, 0),
])
def test_flash_attention_tensor_core_kernel_matches_plain(
        cuda, b, hq, hkv, s, d, causal, window):
    """The bf16 tensor-core instance (wgmma, TMA) at the head dims it
    serves: S not a multiple of any tile (40, 1100), a window that cuts
    a tile (1024 at S 2048, and 64), bidirectional, GQA 8/4 and MHA;
    rtol = atol = 2e-2."""
    q, k, v = _card_attn(cuda, s + d + window, b, hq, hkv, s, d,
                         torch.bfloat16)
    got = flash_mod.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    # the CUDA-core instance computes the same function
    old = flash_mod.flash_attention(q, k, v, causal=causal, window=window,
                                    fma=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(old.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (3, 4, 2, 24, 16), (4, 8, 4, 600, 256), (3, 4, 4, 513, 128),
    (2, 6, 2, 40, 64), (3, 4, 4, 300, 112),
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


SSD_CARD_SHAPES = [  # (b, s, h, p, n, chunk)
    (2, 128, 2, 16, 32, 32), (2, 256, 4, 16, 32, 64),
    (2, 256, 4, 32, 64, 128),          # tests/test_kernels.py's sweep
    (3, 64, 3, 8, 16, 16),             # the smoke configs' SSM
    (2, 512, 3, 64, 128, 256),         # mamba2-2.7b's head and state
    (2, 512, 2, 64, 64, 256),          # zamba2-7b's
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CARD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, dtype, b, s, h, p, n, chunk):
    """y and the final state against the sequential recurrence, with
    pad rows (dt = 0 past each row's length: the state must stop at the
    row's true end).  rtol = atol = 2e-3 in f32, as
    tests/test_kernels.py holds the Pallas kernel; 2e-2 in bf16."""
    dt_ = getattr(torch, dtype)
    lens = [s, s - chunk // 2 - 3, 5][:b]
    x, dt, a, bm, cm = _ssd_inputs(s + p + n, b, s, h, p, n, lens=lens)
    x, bm, cm = (torch.as_tensor(v).to(cuda, dt_) for v in (x, bm, cm))
    dt, a = (torch.as_tensor(v).to(cuda) for v in (dt, a))
    y, state = ssd_mod.ssd(x, dt, a, bm, cm, chunk=chunk)
    y_want, state_want = ref.ssd_ref(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    tol = 2e-3 if dt_ == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, state_want, rtol=tol, atol=tol)
    # the final state of a padded row is its state at its true end
    n1 = lens[1]
    _, at_end = ref.ssd_ref(x[1:2, :n1], dt[1:2, :n1], a, bm[1:2, :n1],
                            cm[1:2, :n1])
    torch.testing.assert_close(state[1:2], at_end, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("h,n", [(8, 128), (7, 64)])   # mamba2, zamba2
def test_ssd_tensor_core_kernel_matches_plain(cuda, h, n):
    """The bf16 tensor-core instance at mamba2's and zamba2's head_dim 64,
    d_state 128 / 64 and chunk 256 (an odd head count too), rows of
    1024, 700 and 37 tokens (dt = 0 past them): y and the final state
    against the sequential recurrence, rtol = atol = 2e-2, and the 37-
    token row's state equal to its state at its true end."""
    b, s, p, chunk = 3, 1024, 64, 256
    lens = [1024, 700, 37]
    x, dt, a, bm, cm = _ssd_inputs(h + n, b, s, h, p, n, lens=lens)
    x, bm, cm = (torch.as_tensor(v).to(cuda, torch.bfloat16)
                 for v in (x, bm, cm))
    dt, a = (torch.as_tensor(v).to(cuda) for v in (dt, a))
    assert ssd_mod.uses_tensor_cores(x, n)
    y, state = ssd_mod.ssd(x, dt, a, bm, cm, chunk=chunk)
    y_want, state_want = ref.ssd_ref(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(state, state_want, rtol=2e-2, atol=2e-2)
    _, at_end = ref.ssd_ref(x[2:, :37], dt[2:, :37], a, bm[2:, :37],
                            cm[2:, :37])
    torch.testing.assert_close(state[2:], at_end, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, a, bm, cm = (torch.as_tensor(v).to(cuda)
                        for v in _ssd_inputs(0, 1, 32, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple"):   # S % Q != 0
        ssd_mod.ssd(x, dt, a, bm, cm, chunk=64)
    with pytest.raises(TypeError):                      # dt not f32
        ssd_mod.ssd(x, dt.bfloat16(), a, bm, cm, chunk=16)
    with pytest.raises(TypeError):                      # x and B differ
        ssd_mod.ssd(x, dt, a, bm.bfloat16(), cm, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_mod.ssd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a,
                    bm, cm, chunk=16)
    with pytest.raises(ValueError):                     # G = 2 groups
        ssd_mod.ssd(x, dt, a, bm.reshape(1, 32, 2, 8),
                    cm.reshape(1, 32, 2, 8), chunk=16)
    with pytest.raises(ValueError, match="d_state"):    # no such instance
        ssd_mod.ssd(x[..., :4].contiguous(), dt, a, bm, cm, chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(128, 64), (256, 512), (64, 128),
                                    (7, 5120), (3, 7168)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d):
    """tests/test_kernels.py's shapes, an odd row count and the widest
    norm of the configs; the scale in f32 and in x's dtype."""
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    x = torch.randn(rows, d, generator=g, device=cuda).to(dt_)
    scale = 0.1 * torch.randn(d, generator=g, device=cuda)
    tol = TOL if dt_ == torch.float32 else 2e-2
    for sc in (scale, scale.to(dt_)):
        got = rmsnorm_mod.rmsnorm(x, sc)
        want = ref.rmsnorm_ref(x, sc)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    with pytest.raises(ValueError):   # D not a whole number of 16-byte words
        rmsnorm_mod.rmsnorm(torch.zeros(2, 6, device=cuda),
                            torch.zeros(6, device=cuda))
