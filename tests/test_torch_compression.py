"""The port's int8 gradient compression (``repro_torch.distributed.
compression``) against the JAX package's on the same inputs: ``quantize``
bit for bit, the round-trip and error-feedback properties of
tests/test_properties.py, and the pod-axis sync of
tests/test_training.py::test_compressed_pod_grad_sync_subprocess over a
``torch.distributed`` mesh — one rank in this process (gloo over a
``HashStore``), two processes as two pods, and eight processes on that
test's own ``(pod 2, data 2, model 2)`` mesh (gloo over a ``FileStore``,
started with ``spawn``, ~10 s and ~20 s).

A compressed gradient is a step function of the gradient: where the two
frameworks' gradients differ in their last bits, an element can land one
int8 step away.  So compressed results are held to JAX's within one
quantization step (``scale / n_pods``), and the elements that differ are
counted and printed.
"""

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")

import hypothesis.strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compress_residual,
    dequantize,
    pod_manual_value_and_grad,
    quantize,
    value_and_grad,
)

ROOT = Path(__file__).resolve().parents[1]
AXES = ("pod", "data", "model")
# tests/test_training.py::test_compressed_pod_grad_sync_subprocess's
# inputs (JAX's own arrays: jnp.linspace rounds other than numpy's) and
# bounds
W = np.asarray(jnp.linspace(-1.0, 1.0, 16).reshape(4, 4))
X = np.asarray(jnp.arange(32.0).reshape(8, 4) / 32.0)
LOSS_TOL, PLAIN_TOL, COMPRESSED_TOL = 1e-5, 1e-5, 5e-3


def loss_fn(w, batch):
    return torch.mean((batch @ w) ** 2)


# ---------------------------------------------------------------------------
# tests/test_properties.py's properties, on the port
# ---------------------------------------------------------------------------


@given(st.lists(st.floats(-100.0, 100.0), min_size=1, max_size=256))
@settings(max_examples=150, deadline=None)
def test_quantize_roundtrip_error_bound(vals):
    g = torch.tensor(np.array(vals, np.float32))
    q, s = quantize(g)
    err = (dequantize(q, s) - g).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-6  # half-step rounding


@given(st.lists(st.floats(-10.0, 10.0), min_size=1, max_size=128))
@settings(max_examples=100, deadline=None)
def test_error_feedback_residual_identity(vals):
    g = torch.tensor(np.array(vals, np.float32))
    q, s, r = compress_residual(g)
    recon = dequantize(q, s) + r
    np.testing.assert_allclose(recon.numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# quantize against JAX's
# ---------------------------------------------------------------------------


def _inputs(case):
    rng = np.random.default_rng(7)
    if case == "zeros":            # the 1e-12 clamp
        return np.zeros((5, 3), np.float32)
    if case == "halfway":          # scale 1: ties round half to even
        return np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -127.0],
                        np.float32)
    if case == "normal":
        return rng.standard_normal((64, 48)).astype(np.float32)
    # magnitudes over 12 decades, most of them below one int8 step
    return (rng.standard_normal(4096)
            * 10.0 ** rng.uniform(-8, 4, 4096)).astype(np.float32)


@pytest.mark.parametrize("case", ["zeros", "halfway", "normal", "decades"])
def test_quantize_matches_jax(case):
    """``q`` exactly and ``scale`` to the f32 bit; ``dequantize`` and the
    residual of ``compress_residual`` exactly."""
    g = _inputs(case)
    q, s, r = compress_residual(torch.tensor(g))
    jq, js, jr = jcomp.compress_residual(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(dequantize(q, s).numpy(),
                                  np.asarray(jcomp.dequantize(jq, js)))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    if case == "zeros":
        assert float(s) == np.float32(1e-12) and not q.any()


# ---------------------------------------------------------------------------
# one rank in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank():
    """A one-rank gloo world over a ``HashStore``, destroyed after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_mesh_without_pod_is_the_plain_value_and_grad(one_rank):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    w, x = torch.tensor(W), torch.tensor(X)
    loss, g = pod_manual_value_and_grad(loss_fn, mesh)(w, x)
    want_loss, want = value_and_grad(loss_fn)(w, x)
    assert torch.equal(loss, want_loss) and torch.equal(g, want)


@pytest.mark.parametrize("leaves", [None, [["w", "b"], ["unused"]]],
                         ids=["a_leaf_a_tensor", "w_and_b_one_leaf"])
def test_one_pod_quantizes_every_gradient(one_rank, leaves):
    """A 1-pod mesh is no identity sync: every leaf's gradient comes back
    as ``dequantize(*quantize(g))`` of the plain one (the tensors of a
    leaf quantized as one), bit for bit, and the loss is the plain
    loss; uncompressed, the gradient is the plain one."""
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=AXES)
    rng = np.random.default_rng(0)
    params = {"w": torch.tensor(W),
              "b": torch.tensor(rng.standard_normal(4).astype(np.float32)),
              "unused": torch.ones(3)}

    def loss2(p, batch):
        return torch.mean((batch @ p["w"] + p["b"]) ** 2)

    x = torch.tensor(X)
    want_loss, want = value_and_grad(loss2)(params, x)
    loss, got = pod_manual_value_and_grad(loss2, mesh,
                                          leaves=leaves)(params, x)
    assert torch.equal(loss, want_loss)
    assert got.keys() == want.keys()
    for names in leaves or [[n] for n in want]:
        flat = torch.cat([want[n].flatten() for n in names])
        assert torch.equal(torch.cat([got[n].flatten() for n in names]),
                           dequantize(*quantize(flat))), names
    assert not got["unused"].any()
    assert not torch.equal(got["w"], want["w"])   # really quantized
    loss, plain = pod_manual_value_and_grad(loss2, mesh,
                                            compress=False)(params, x)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(plain[n], want[n]) for n in want)


# ---------------------------------------------------------------------------
# two processes as two pods
# ---------------------------------------------------------------------------


def _pod_worker(rank, store_path, out_dir):
    """One pod of the 2-pod mesh: the compressed and the uncompressed
    value_and_grad of ``loss_fn`` over its half of ``X``, and a batch
    that does not split over the pods."""
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (2, 1, 1), mesh_dim_names=AXES)
        assert mesh.get_local_rank("pod") == rank
        w, x = torch.tensor(W), torch.tensor(X)
        lc, gc = pod_manual_value_and_grad(loss_fn, mesh)(w, x)
        lr, gr = pod_manual_value_and_grad(loss_fn, mesh,
                                           compress=False)(w, x)
        try:
            pod_manual_value_and_grad(loss_fn, mesh)(w, x[:7])
            odd = "no error"
        except ValueError as e:
            odd = str(e)
        torch.save({"lc": lc, "gc": gc, "lr": lr, "gr": gr, "odd": odd},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n, tmp_path, timeout=120.0):
    """Run ``fn(rank, store_path, out_dir)`` in ``n`` spawned processes
    and return each rank's saved result; any rank that fails or outlives
    ``timeout`` fails the caller."""
    ctx = mp.start_processes(fn, args=(str(tmp_path / "store"),
                                       str(tmp_path)),
                             nprocs=n, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {timeout} s")
    assert [p.exitcode for p in ctx.processes] == [0] * n
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]


_JAX_2POD = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.distributed.compression import pod_manual_value_and_grad

mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"))
w = jnp.linspace(-1.0, 1.0, 16).reshape(4, 4)
x = jnp.arange(32.0).reshape(8, 4) / 32.0

def loss_fn(w, batch):
    return jnp.mean((batch @ w) ** 2)

xb = jax.device_put(x, NamedSharding(mesh, P(("pod", "data"), None)))
lc, gc = jax.jit(pod_manual_value_and_grad(loss_fn, mesh))(w, xb)
print(json.dumps({"lc": float(lc), "gc": np.asarray(gc).tolist()}))
"""


def test_compressed_pod_grad_sync_two_processes(tmp_path):
    """tests/test_training.py's case with 2 processes as 2 pods on a
    ``(pod 2, data 1, model 1)`` mesh: loss within 1e-5, uncompressed
    gradients within 1e-5 and compressed within 5e-3 of the one-process
    reference over the whole batch; both ranks agree bit for bit; the
    compressed gradient is within one quantization step of JAX's on the
    same ``w`` and ``x`` (JAX on a 2-device host mesh in a subprocess);
    a batch that does not split over the pods raises."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen([sys.executable, "-c", _JAX_2POD], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
    ranks = run_ranks(_pod_worker, 2, tmp_path)
    out, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])

    w, x = torch.tensor(W), torch.tensor(X)
    ref_l, ref_g = value_and_grad(loss_fn)(w, x)
    for r in ranks[1:]:
        for k in ("lc", "gc", "lr", "gr"):
            assert torch.equal(r[k], ranks[0][k]), k
    got = ranks[0]
    assert abs(float(got["lc"]) - float(ref_l)) < LOSS_TOL
    assert abs(float(got["lr"]) - float(ref_l)) < LOSS_TOL
    err_r = float((got["gr"] - ref_g).abs().max())
    err_c = float((got["gc"] - ref_g).abs().max())
    assert err_r < PLAIN_TOL, err_r
    assert err_c < COMPRESSED_TOL, err_c
    assert all("does not split" in r["odd"] for r in ranks)

    # one quantization step: the shared scale over the two pods' halves
    per_pod = [value_and_grad(loss_fn)(w, half)[1] for half in x.split(4)]
    scale = max(float(g.abs().max()) for g in per_pod) / 127.0
    step = scale / 2
    jgc = np.asarray(want["gc"], np.float32)
    diff = np.abs(got["gc"].numpy() - jgc)
    n_diff = int((diff > 0).sum())
    print(f"compressed vs JAX: {n_diff} of {diff.size} elements differ, "
          f"max {diff.max():.3g}, one step {step:.3g}")
    assert diff.max() <= step, (diff.max(), step)
    assert abs(float(got["lc"]) - want["lc"]) < LOSS_TOL


# ---------------------------------------------------------------------------
# eight processes on JAX's (pod 2, data 2, model 2) mesh
# ---------------------------------------------------------------------------


def _mesh222_worker(rank, store_path, out_dir):
    """One rank of tests/test_training.py's ``(2, 2, 2)`` mesh: every
    ``data`` and ``model`` rank of a pod differentiates the pod's whole
    block, as JAX's SPMD partition computes it (here replicated)."""
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 8),
                            rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=AXES)
        assert [mesh.get_local_rank(a) for a in AXES] == [
            rank // 4, rank // 2 % 2, rank % 2]
        w, x = torch.tensor(W), torch.tensor(X)
        lc, gc = pod_manual_value_and_grad(loss_fn, mesh)(w, x)
        lr, gr = pod_manual_value_and_grad(loss_fn, mesh,
                                           compress=False)(w, x)
        torch.save({"lc": lc, "gc": gc, "lr": lr, "gr": gr},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


_JAX_222 = (_JAX_2POD.replace("device_count=2", "device_count=8")
            .replace("(2, 1, 1)", "(2, 2, 2)"))


def test_compressed_pod_grad_sync_on_jax_mesh_222(tmp_path):
    """tests/test_training.py's own case, on its ``(pod 2, data 2,
    model 2)`` mesh as 8 processes: loss within 1e-5, uncompressed
    gradients within 1e-5 and compressed within 5e-3 of the one-process
    reference over the whole batch; all 8 ranks agree bit for bit; the
    compressed gradient is within one quantization step of JAX's on the
    same mesh (8 host devices, in a subprocess)."""
    assert "device_count=8" in _JAX_222 and "(2, 2, 2)" in _JAX_222
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen([sys.executable, "-c", _JAX_222], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
    ranks = run_ranks(_mesh222_worker, 8, tmp_path, timeout=240.0)
    out, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])

    w, x = torch.tensor(W), torch.tensor(X)
    ref_l, ref_g = value_and_grad(loss_fn)(w, x)
    for r in ranks[1:]:
        for k in ("lc", "gc", "lr", "gr"):
            assert torch.equal(r[k], ranks[0][k]), k
    got = ranks[0]
    assert abs(float(got["lc"]) - float(ref_l)) < LOSS_TOL
    assert abs(float(got["lr"]) - float(ref_l)) < LOSS_TOL
    err_r = float((got["gr"] - ref_g).abs().max())
    err_c = float((got["gc"] - ref_g).abs().max())
    assert err_r < PLAIN_TOL, err_r
    assert err_c < COMPRESSED_TOL, err_c

    # one quantization step: the scale shared over the two pods' blocks
    per_pod = [value_and_grad(loss_fn)(w, half)[1] for half in x.split(4)]
    scale = max(float(g.abs().max()) for g in per_pod) / 127.0
    step = scale / 2
    diff = np.abs(got["gc"].numpy() - np.asarray(want["gc"], np.float32))
    print(f"compressed vs JAX on (2, 2, 2): {int((diff > 0).sum())} of "
          f"{diff.size} elements differ, max {diff.max():.3g}, one step "
          f"{step:.3g}")
    assert diff.max() <= step, (diff.max(), step)
    assert abs(float(got["lc"]) - want["lc"]) < LOSS_TOL
