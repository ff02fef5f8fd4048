"""Training of the PyTorch port against the JAX package on the same
weights and data: ``Model.loss`` and every gradient (six families, with
and without remat), AdamW step for step, micro-batching, the data
pipeline and ``batch_spec``, the fault-tolerant runner's crash and
resume, the ``train`` launcher, and the train step over a device mesh
(the int8 pod-axis sync on a one-rank gloo mesh against JAX's
``build_train_step`` over a 1-device mesh).  Ports of
tests/test_training.py's cases.

f32 on the CPU.  Loss and gradients within 1e-4 relative to each
tensor's largest magnitude (the two frameworks sum the same f32
products in another order, through the backward pass too); AdamW
within 1e-6 (the same elementwise f32 arithmetic, the global norm
summed over the leaves in another order).
"""

import dataclasses
import datetime
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed.fault_tolerance import (  # noqa: E402
    RunnerConfig as JRunnerConfig,
)
from repro.distributed.fault_tolerance import (  # noqa: E402
    TrainRunner as JTrainRunner,
)
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.data import DataConfig as JDataConfig  # noqa: E402
from repro.training.data import batch_spec as jbatch_spec  # noqa: E402
from repro.training.data import make_batch as jmake_batch  # noqa: E402
from repro.training.train_loop import TrainConfig as JTrainConfig  # noqa: E402,E501
from repro.training.train_loop import (  # noqa: E402
    build_train_step as jbuild_train_step,
)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed.checkpoint import latest_step  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    pod_manual_value_and_grad,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    InjectedFailure,
    RunnerConfig,
    TrainRunner,
)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax,
    stacked_leaves,
)
from repro_torch.training.data import (  # noqa: E402
    DataConfig,
    batch_spec,
    make_batch,
)
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.training.train_loop import (  # noqa: E402
    TrainConfig,
    build_train_step,
    trained_params,
    value_and_grad,
)

GRAD_TOL = 1e-4
ADAMW_TOL = 1e-6
ARCHS = ["qwen7b", "gemma3-4b", "mamba2-2.7b", "zamba2-7b", "olmoe-1b-7b",
         "hubert-xlarge"]


@functools.lru_cache(maxsize=None)
def _jax_side(arch, remat=False):
    """(JAX model, its params for key 3, the numpy tree)."""
    jm = jax_build(jax_smoke(arch), remat=remat)
    jp = jm.init(jax.random.key(3))
    return jm, jp, jax.tree.map(np.asarray, jp)


def _port(arch, remat=False, use_kernels=False):
    """The port's smoke model on the CPU with the JAX weights."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="cpu", remat=remat, use_kernels=use_kernels)
    model.load_state_dict(params_from_jax(_jax_side(arch)[2], cfg))
    return model


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    if scale == 0:
        return float(np.abs(got).max())   # must be exactly zero too
    return float(np.abs(got - want).max() / scale)


def _batch(arch, b=2, s=24, step=0):
    return make_batch(get_smoke_config(arch), DataConfig(b, s, seed=5), step)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, remat):
    """``value_and_grad`` of the port's ``Model.loss`` against
    ``jax.value_and_grad(model.loss)`` on the same weights and batch:
    dense (qwen7b, QKV bias), gemma3's local/global windows, mamba2's
    plain SSD scan, zamba2's shared block (its gradient sums over its
    invocations), olmoe's MoE aux (``lb_loss``) and hubert's masked
    prediction over frames (no gradient reaches its ``embed``: zeros in
    both).  Every gradient, by name, within 1e-4 relative."""
    jm, jp, _ = _jax_side(arch, remat)
    batch = _batch(arch)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port(arch, remat)
    params = trained_params(model)
    loss, grads = value_and_grad(
        model, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert _rel_err(loss.numpy(), np.asarray(jloss)) <= GRAD_TOL
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    assert want.keys() == grads.keys()
    errs = {n: _rel_err(g.numpy(), want[n].numpy())
            for n, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    # gradients are on only for the call: serving stays graph-free
    assert not any(p.requires_grad for p in model.parameters())
    if arch == "hubert-xlarge":
        assert not grads["embed"].any()


def test_value_and_grad_takes_only_the_models_own_parameters():
    model = _port("qwen7b")
    batch = {k: torch.as_tensor(v) for k, v in _batch("qwen7b").items()}
    copies = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="own parameters"):
        value_and_grad(model, copies, batch)


def test_kernel_route_refuses_to_train():
    """A model built with ``use_kernels=True`` raises instead of training
    with its attention cut out of the gradient (the kernels have no
    backward); under ``no_grad`` its forward equals the plain route's
    (full lengths)."""
    model = _port("qwen7b", use_kernels=True)
    batch = {k: torch.as_tensor(v) for k, v in _batch("qwen7b").items()}
    with pytest.raises(RuntimeError, match="no backward"):
        value_and_grad(model, trained_params(model), batch)
    with torch.no_grad():
        got = model.loss(batch)
    want = _port("qwen7b").loss(batch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _adamw_both(cfg, grads_seq, params):
    """Run the same gradient sequence through both packages' AdamW;
    return the port's and JAX's (params, state, stats) after each step
    (the port's copied: it updates its tensors in place)."""
    tp = {n: torch.tensor(v) for n, v in params.items()}
    ts = adamw_init(tp)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = jopt.adamw_init(jp)
    out = []
    for grads in grads_seq:
        tp, ts, tstats = adamw_update(
            cfg, {n: torch.tensor(g) for n, g in grads.items()}, ts, tp)
        jp, js, jstats = jopt.adamw_update(
            cfg, {n: jnp.asarray(g) for n, g in grads.items()}, js, jp)
        snap = ({n: t.clone() for n, t in tp.items()},
                ts._replace(mu={n: t.clone() for n, t in ts.mu.items()},
                            nu={n: t.clone() for n, t in ts.nu.items()}),
                tstats)
        out.append((snap, (jp, js, jstats)))
    return out


def _assert_adamw_equal(port, jax_out):
    (tp, ts, tstats), (jp, js, jstats) = port, jax_out
    for n in tp:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=ADAMW_TOL, atol=ADAMW_TOL)
        np.testing.assert_allclose(ts.mu[n].numpy(), np.asarray(js.mu[n]),
                                   rtol=ADAMW_TOL, atol=ADAMW_TOL)
        np.testing.assert_allclose(ts.nu[n].numpy(), np.asarray(js.nu[n]),
                                   rtol=ADAMW_TOL, atol=ADAMW_TOL)
    assert int(ts.step) == int(js.step)
    np.testing.assert_allclose(float(ts.norm_ema), float(js.norm_ema),
                               rtol=ADAMW_TOL)
    for key in ("grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(float(tstats[key]), float(jstats[key]),
                                   rtol=ADAMW_TOL)


def test_adamw_step_matches_jax():
    """Params, both moments, the step, the guard's norm EMA and the
    stats after each of 8 steps — warm-up, a clipped step (norm > 1),
    an anomalous spike the guard skips (its moments still decay) — equal
    ``adamw_update``'s within 1e-6."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 5), np.float32),
              "b": rng.standard_normal((5,), np.float32)}
    grads_seq = []
    for i in range(8):
        scale = {0: 0.05, 3: 0.25, 5: 400.0}.get(i, 0.2)
        grads_seq.append({n: scale * rng.standard_normal(v.shape, np.float32)
                          for n, v in params.items()})
    cfg = AdamWConfig(lr=0.05, warmup_steps=4)
    assert cfg == AdamWConfig(**dataclasses.asdict(
        jopt.AdamWConfig(lr=0.05, warmup_steps=4)))
    steps = _adamw_both(cfg, grads_seq, params)
    for port, jax_out in steps:
        _assert_adamw_equal(port, jax_out)
    assert float(steps[3][0][2]["grad_norm"]) > cfg.grad_clip
    assert [float(p[2]["skipped"]) for p, _ in steps] == [0.0] * 5 + [1.0] \
        + [0.0] * 2


def test_adamw_optimizes_quadratic():
    """tests/test_training.py's case: 200 steps on |w|^2 from (5, -3)
    reach |w| < 0.05, and the iterates equal JAX's."""
    tp = {"w": torch.tensor([5.0, -3.0])}
    ts = adamw_init(tp)
    jp = {"w": jnp.array([5.0, -3.0])}
    js = jopt.adamw_init(jp)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    jcfg = jopt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    for _ in range(200):
        tp, ts, _ = adamw_update(cfg, {"w": 2 * tp["w"]}, ts, tp)
        jp, js, _ = jopt.adamw_update(jcfg, {"w": 2 * jp["w"]}, js, jp)
    assert float(tp["w"].abs().max()) < 0.05
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=0, atol=1e-5)


def test_adamw_skips_anomalous_step():
    """tests/test_training.py's case: after 20 unit gradients a 1e6
    spike is skipped — the parameters stay put — as in JAX."""
    cfg = AdamWConfig(lr=0.1, skip_anomalous=True, anomaly_factor=5.0,
                      warmup_steps=1)
    grads_seq = [{"w": np.ones(4, np.float32)}] * 20
    grads_seq.append({"w": np.full(4, 1e6, np.float32)})
    steps = _adamw_both(cfg, grads_seq, {"w": np.ones(4, np.float32)})
    before = steps[-2][0][0]["w"]
    (tp, _, stats), jax_out = steps[-1]
    assert float(stats["skipped"]) == 1.0 == float(jax_out[2]["skipped"])
    assert torch.equal(tp["w"], before)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jax_out[0]["w"]),
                               rtol=ADAMW_TOL, atol=ADAMW_TOL)


def test_micro_batching_matches_full_batch():
    """tests/test_training.py's case on qwen7b's smoke config: one step
    over 2 micro-batches equals one over the full batch (loss within
    1e-3, parameters within 1e-4), and both equal JAX's steps."""
    cfg = get_smoke_config("qwen7b")
    batch = make_batch(cfg, DataConfig(batch=4, seq_len=16), 0)
    jm, jp, _ = _jax_side("qwen7b")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    results = {}
    for n_micro in (1, 2):
        model = _port("qwen7b")
        params = trained_params(model)
        step = build_train_step(model, TrainConfig(micro_batches=n_micro))
        params, _, metrics = step(params, adamw_init(params),
                                  {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
        jstep = jax.jit(jbuild_train_step(
            jm, JTrainConfig(micro_batches=n_micro)))
        jparams, _, jmetrics = jstep(jp, jopt.adamw_init(jp), jbatch)
        want = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=0, atol=1e-5)
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) < 1e-5
        results[n_micro] = ({n: p.detach().clone()
                             for n, p in params.items()},
                            float(metrics["loss"]))
    (p1, l1), (p2, l2) = results[1], results[2]
    assert abs(l1 - l2) < 1e-3
    assert max(float((p1[n] - p2[n]).abs().max()) for n in p1) < 1e-4


def test_data_pipeline_matches_jax_and_is_stateless():
    """make_batch is a pure function of (seed, step), and equals the JAX
    package's array for array, for a token and a frames model."""
    for arch in ("qwen7b", "hubert-xlarge"):
        cfg = get_smoke_config(arch)
        dc = DataConfig(batch=4, seq_len=8, seed=3)
        b1, b2 = make_batch(cfg, dc, 11), make_batch(cfg, dc, 11)
        want = jmake_batch(jax_smoke(arch), JDataConfig(4, 8, seed=3), 11)
        assert b1.keys() == want.keys()
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k])
            np.testing.assert_array_equal(b1[k], want[k])
            assert b1[k].dtype == want[k].dtype
        key = "frames" if arch == "hubert-xlarge" else "tokens"
        assert not np.array_equal(b1[key], make_batch(cfg, dc, 12)[key])


@pytest.mark.parametrize("arch", ["qwen7b", "hubert-xlarge"])
def test_batch_spec_matches_jax_and_make_batch(arch):
    """Full width: meta tensors with the shapes and dtypes of JAX's
    ``ShapeDtypeStruct``s and of ``make_batch``'s arrays."""
    dc = DataConfig(batch=4, seq_len=8)
    spec = batch_spec(get_config(arch), dc)
    want = jbatch_spec(jax_config(arch), JDataConfig(4, 8))
    arrays = make_batch(get_config(arch), dc, 0)
    assert spec.keys() == want.keys() == arrays.keys()
    dtypes = {np.dtype(np.int32): torch.int32,
              np.dtype(np.float32): torch.float32}
    for k, t in spec.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape == arrays[k].shape
        assert t.dtype == dtypes[np.dtype(want[k].dtype)]
        assert t.dtype == torch.as_tensor(arrays[k]).dtype


def _from_jax_weights(model, arch):
    """Make ``model.init`` load the JAX weights of ``_jax_side`` (the
    runner draws its weights through it), so a run starts where JAX's
    run with ``jax.random.key(3)`` does."""
    state = params_from_jax(_jax_side(arch)[2], model.cfg)

    def init(generator):
        model.load_state_dict(state)
        return model

    model.init = init


@pytest.mark.parametrize("arch", ["qwen7b", "hubert-xlarge"])
def test_crash_resume_end_to_end(tmp_path, arch):
    """tests/test_training.py's case: a run that crashes after 6 steps
    (checkpoints every 4) resumes from step 4 and finishes; its final
    parameters, optimizer state and logged losses equal an uninterrupted
    run's exactly (the same steps on the same tensors), and its losses
    equal the JAX runner's over the same 12 steps within 1e-4."""
    cfg = get_smoke_config(arch)
    dc = DataConfig(batch=2, seq_len=16)

    def runner(d, crash_after=None):
        model = Model(cfg, device="cpu", remat=True, use_kernels=False)
        _from_jax_weights(model, arch)
        rc = RunnerConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(d),
                          crash_after=crash_after, log_every=1)
        return TrainRunner(model, dc, TrainConfig(), rc)

    whole = runner(tmp_path / "whole").run(torch.Generator())
    d = tmp_path / "ckpt"
    with pytest.raises(InjectedFailure):
        runner(d, crash_after=6).run(torch.Generator())
    assert latest_step(str(d)) == 4
    out = runner(d).run(torch.Generator())
    assert out["resumed_from"] == 4
    assert out["final_loss"] == whole["final_loss"]
    assert out["history"] == whole["history"][4:]
    for n, p in out["params"].items():
        assert torch.equal(p, whole["params"][n]), n
    for part in ("mu", "nu"):
        for n, t in getattr(out["opt_state"], part).items():
            assert torch.equal(t, getattr(whole["opt_state"], part)[n])
    assert torch.equal(out["opt_state"].norm_ema,
                       whole["opt_state"].norm_ema)

    jm, jp, _ = _jax_side(arch, True)
    jout = JTrainRunner(
        jm, JDataConfig(batch=2, seq_len=16), JTrainConfig(),
        JRunnerConfig(total_steps=12, ckpt_every=100,
                      ckpt_dir=str(tmp_path / "jax"), log_every=1),
    ).run(jax.random.key(3))
    assert [h["step"] for h in jout["history"]] == list(range(1, 13))
    for got, want in zip(whole["history"], jout["history"]):
        assert got["step"] == want["step"]
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])


def test_train_launcher_runs_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``: 6
    steps with checkpoints every 3, then a second launch to 9 steps
    resumes from step 6 and runs 3."""
    argv = ["--arch", "qwen2.5-14b", "--smoke", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--device", "cpu"]
    train_cli.main([*argv, "--steps", "6"])
    first = capsys.readouterr().out
    assert "arch=qwen2.5-14b-smoke" in first
    assert "done: 6 steps" in first
    assert latest_step(str(tmp_path)) == 6
    train_cli.main([*argv, "--steps", "9"])
    second = capsys.readouterr().out
    assert "done: 3 steps" in second
    assert latest_step(str(tmp_path)) == 9
    loss = float(second.rsplit("final loss ", 1)[1])
    assert np.isfinite(loss)


def test_train_launcher_defaults_to_cuda_and_raises_without_it(
        monkeypatch, tmp_path):
    """Like every entry point of the port, the launcher trains on the
    card unless ``--device`` names another, and never drops to the CPU
    quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "hubert-xlarge", "--smoke", "--steps", "1",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main([*argv, "--device", "cuda"])
    assert latest_step(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# the train step over a device mesh
# ---------------------------------------------------------------------------

AXES = ("pod", "data", "model")


@pytest.fixture
def one_rank():
    """A one-rank gloo world over a ``HashStore``, destroyed after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("dims,compress", [(("data", "model"), True),
                                           (AXES, False)],
                         ids=["no_pod", "compression_off"])
def test_a_mesh_without_the_pod_sync_is_the_plain_step(one_rank, dims,
                                                        compress):
    """A mesh without ``pod`` (compression on) or with it (compression
    off) gives the step ``mesh=None`` gives, bit for bit: parameters,
    moments and metrics (2 micro-batches: that path is taken too)."""
    mesh = init_device_mesh("cpu", (1,) * len(dims), mesh_dim_names=dims)
    cfg = TrainConfig(grad_compression=compress, micro_batches=2)
    batch = _tbatch(_batch("qwen7b", b=4, s=16))
    out = []
    for m in (None, mesh):
        model = _port("qwen7b")
        params = trained_params(model)
        out.append(build_train_step(model, cfg, m)(
            params, adamw_init(params), batch))
    (p0, s0, m0), (p1, s1, m1) = out
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
        assert torch.equal(s0.mu[n], s1.mu[n])
        assert torch.equal(s0.nu[n], s1.nu[n])
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


@pytest.mark.parametrize("arch", ["qwen7b", "hubert-xlarge"])
def test_one_pod_compressed_step_matches_jax(one_rank, arch):
    """``grad_compression`` on a one-rank ``(pod 1, data 1, model 1)``
    mesh against JAX's ``build_train_step`` over
    ``jax.make_mesh((1, 1, 1), ...)`` from the same weights: loss within
    1e-5 relative; each compressed gradient within one quantization step
    of JAX's (a scale per JAX leaf, a parameter stacked over a segment's
    layers: the step from each side's max, plus 127 times their
    difference); parameters after one AdamW step within 1e-5,
    except where a gradient landed one step away from JAX's: step 1
    moves a weight by about ``lr * sign(g)``, so there up to lr + 1e-5.
    Those elements are counted and printed."""
    cfg = get_smoke_config(arch)
    jm, jp, _ = _jax_side(arch, True)
    batch = _batch(arch, b=2, s=24)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    adamw = AdamWConfig(lr=1e-2, warmup_steps=1)
    jadamw = jopt.AdamWConfig(lr=1e-2, warmup_steps=1)
    jmesh = jax.make_mesh((1, 1, 1), AXES)
    jloss, jgrads = jax.jit(jcomp.pod_manual_value_and_grad(
        jm.loss, jmesh))(jp, jbatch)
    jparams, _, jmetrics = jax.jit(jbuild_train_step(
        jm, JTrainConfig(adamw=jadamw, grad_compression=True), jmesh))(
        jp, jopt.adamw_init(jp), jbatch)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    jparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)

    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=AXES)
    model = _port(arch, remat=True)
    own = trained_params(model)
    loss, grads = pod_manual_value_and_grad(
        lambda p, b: model.loss(b), mesh,
        leaves=stacked_leaves(cfg, own))(own, _tbatch(batch))
    params = trained_params(model)
    params, _, metrics = build_train_step(
        model, TrainConfig(adamw=adamw, grad_compression=True), mesh)(
        params, adamw_init(params), _tbatch(batch))

    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= (
        1e-5 * abs(float(jmetrics["loss"])))
    assert grads.keys() == jgrads.keys() == params.keys()
    n_step = n_moved = 0
    for names in stacked_leaves(cfg, grads):   # one scale per JAX leaf
        s1 = max(float(grads[n].abs().max()) for n in names) / 127
        s2 = max(float(jgrads[n].abs().max()) for n in names) / 127
        step = max(s1, s2) + 127 * abs(s1 - s2)
        for n in names:
            diff = (grads[n] - jgrads[n]).abs()
            assert float(diff.max()) <= step, (n, float(diff.max()), step)
            away = diff > step / 2
            n_step += int(away.sum())
            tol = torch.where(away, adamw.lr + 1e-5, 1e-5)
            moved = (params[n].detach() - jparams[n]).abs()
            assert bool((moved <= tol).all()), (n, float(moved.max()))
            n_moved += int((moved > 1e-5).sum())
    total = sum(g.numel() for g in grads.values())
    print(f"{arch}: {n_step} of {total} gradient elements one step from "
          f"JAX's; {n_moved} parameters moved apart by more than 1e-5")


def _data_axis_worker(rank, store_path, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        model = Model(get_smoke_config("qwen7b"), device="cpu")
        cfg = TrainConfig(grad_compression=True)
        for shape in ((1, 2, 1), (1, 1, 2)):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
            with pytest.raises(NotImplementedError,
                               match=r"ROADMAP\.md §1 item 11"):
                build_train_step(model, cfg, mesh)
        build_train_step(model, cfg, init_device_mesh(
            "cpu", (2, 1, 1), mesh_dim_names=AXES))
    finally:
        dist.destroy_process_group()


def test_a_mesh_with_data_or_model_axes_raises(tmp_path):
    """Two ranks: a mesh with ``data`` 2 or ``model`` 2 raises and names
    the ROADMAP item (the port plans such a mesh but cannot run it: it
    neither shards silently nor drops the axis); ``pod`` 2 builds."""
    ctx = mp.start_processes(_data_axis_worker,
                             args=(str(tmp_path / "store"), str(tmp_path)),
                             nprocs=2, start_method="spawn", join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("ranks still running after 120 s")
    assert [p.exitcode for p in ctx.processes] == [0, 0]
