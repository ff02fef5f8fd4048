"""The port's ``train_small`` example against the JAX package's
(``examples/train_small_torch.py`` beside ``examples/train_small.py``).

Both scripts train the same narrowed ``SMALL`` (patched into each
module: 2 layers, d 64, 4 heads, ff 128, vocab 256) from the same
initial weights — the port's ``Model.init`` loads the tree the JAX
runner draws from ``jax.random.key(0)`` — and log every step (each
module's ``RunnerConfig`` is wrapped to set ``log_every=1``; the
scripts log every 20).  Each module's ``AdamWConfig`` is wrapped to warm
up over ``WARMUP`` steps in place of the scripts' 50, so that most
compared steps update at the full learning rate: the data are uniform
random tokens, which pin the loss near ln(vocab) whatever the update
does, so the updates are held through the gradient norms and the
trained parameters.  Every other setting is the scripts' own.  The JAX
script returns nothing, so its results are read where its
``TrainRunner.run`` returns them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _examples import load, run  # noqa: E402
from repro_torch.distributed.checkpoint import latest_step  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

NARROW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
              vocab_size=256)
WARMUP = 2


def narrowed(mod, monkeypatch):
    """``mod`` with the narrowed ``SMALL``, logging every step and
    warming up over ``WARMUP`` steps."""
    monkeypatch.setattr(mod, "SMALL",
                        dataclasses.replace(mod.SMALL, **NARROW))
    runner_cfg, adamw_cfg = mod.RunnerConfig, mod.AdamWConfig
    monkeypatch.setattr(mod, "RunnerConfig",
                        lambda **kw: runner_cfg(**{**kw, "log_every": 1}))
    monkeypatch.setattr(mod, "AdamWConfig",
                        lambda **kw: adamw_cfg(**{**kw,
                                                  "warmup_steps": WARMUP}))
    return mod


def recorded_runs(runner_cls, monkeypatch) -> list:
    """What each ``runner_cls.run`` returns, in order."""
    outs, run_ = [], runner_cls.run

    def record(self, seed):
        outs.append(run_(self, seed))
        return outs[-1]

    monkeypatch.setattr(runner_cls, "run", record)
    return outs


def test_train_small_matches_jax_and_resumes(tmp_path, monkeypatch,
                                             capsys):
    """``--steps 6 --batch 2 --seq 16``: each step's loss and gradient
    norm within 1e-4 relative of the JAX script's, and the parameters
    after step 6 as JAX's (each tensor's difference within 1 % of how
    far the step-6 update moved it, which is well over 0).  Then the
    port's script on the same
    ``--ckpt-dir`` to 50 steps (no checkpoint yet: it starts over, with
    the same first 6 losses, and checkpoints at 50) and to 52, which
    resumes from step 50 and runs 2."""
    jmod = narrowed(load("train_small"), monkeypatch)
    pmod = narrowed(load("train_small_torch"), monkeypatch)
    tree = jmod.build_model(jmod.SMALL, remat=True).init(jax.random.key(0))
    state = params_from_jax(jax.tree.map(np.asarray, tree), pmod.SMALL)

    def init(self, generator):
        self.load_state_dict(state)
        return self

    monkeypatch.setattr(pmod.Model, "init", init)
    argv = ["--batch", "2", "--seq", "16"]
    port_dir = str(tmp_path / "port")
    pargv = [*argv, "--ckpt-dir", port_dir, "--device", "cpu"]

    jax_out = recorded_runs(jmod.TrainRunner, monkeypatch)
    port_out = recorded_runs(pmod.TrainRunner, monkeypatch)
    got, lines = run(pmod, [*pargv, "--steps", "6"], monkeypatch, capsys)
    _, want = run(jmod, [*argv, "--steps", "6", "--ckpt-dir",
                         str(tmp_path / "jax")], monkeypatch, capsys)
    assert lines[0] == want[0] == "params: 0.1M"
    (jout,) = jax_out
    assert [h["step"] for h in got["history"]] == list(range(1, 7))
    assert [h["step"] for h in jout["history"]] == list(range(1, 7))
    for h, w in zip(got["history"], jout["history"]):
        assert abs(h["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
        assert abs(h["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]
    trained = params_from_jax(jax.tree.map(np.asarray, jout["params"]),
                              pmod.SMALL)
    (pout,) = port_out
    assert pout["params"].keys() == trained.keys() == state.keys()
    for name, want in trained.items():
        moved = float((want - state[name]).abs().max())
        err = float((pout["params"][name].detach() - want).abs().max())
        assert moved > 0, name
        assert err <= 1e-2 * moved, (name, err, moved)
    assert lines[-1].startswith("6 steps in ")
    assert "(resumed from 0)" in lines[-1]
    assert latest_step(port_dir) is None

    longer, _ = run(pmod, [*pargv, "--steps", "50"], monkeypatch, capsys)
    assert longer["resumed_from"] == 0
    assert longer["history"][:6] == got["history"]
    assert latest_step(port_dir) == 50
    resumed, lines = run(pmod, [*pargv, "--steps", "52"], monkeypatch,
                         capsys)
    assert resumed["resumed_from"] == 50 and resumed["steps_run"] == 2
    assert [h["step"] for h in resumed["history"]] == [51, 52]
    assert lines[-1].startswith("2 steps in ")
    assert "(resumed from 50)" in lines[-1]
    assert np.isfinite(resumed["final_loss"])
