"""Fault-tolerant training runner of the port (counterpart of
``repro/distributed/fault_tolerance.py``).

- periodic atomic checkpoints (params + optimizer + step) through
  :mod:`repro_torch.distributed.checkpoint`;
- auto-resume from the latest checkpoint (crash-safe: partial writes
  live in `.tmp_*` dirs that are never picked up);
- in-step anomaly guard (see AdamWConfig.skip_anomalous) protects the
  optimizer from straggler-corrupted steps;
- a `crash_after` hook lets tests inject failures deterministically.

The checkpoint module stores a flat name -> tensor map, so
``(params, AdamWState)`` is stored under fixed prefixes —
``params/<name>``, ``mu/<name>``, ``nu/<name>``, ``step`` and
``norm_ema`` — and restored exactly (the parameters into the model's
own tensors).  The JAX runner's ``jit_kwargs`` has no counterpart: the
step runs eagerly.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import torch

from repro_torch.distributed.checkpoint import load_latest, save_checkpoint
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import (
    TrainConfig,
    build_train_step,
    init_train_state,
)

# default checkpoint directory: the checkout's git-ignored build/
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" /
                       "train_ckpt")


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = DEFAULT_CKPT_DIR
    keep_last: int = 3
    log_every: int = 10
    crash_after: Optional[int] = None  # test hook: raise after N steps


def flatten_state(params: dict, opt_state: AdamWState) -> dict:
    """``(params, AdamWState)`` as one flat name -> tensor map."""
    flat = {f"params/{n}": p for n, p in params.items()}
    flat.update({f"mu/{n}": t for n, t in opt_state.mu.items()})
    flat.update({f"nu/{n}": t for n, t in opt_state.nu.items()})
    flat["step"] = opt_state.step
    flat["norm_ema"] = opt_state.norm_ema
    return flat


@torch.no_grad()
def restore_state(params: dict, flat: dict) -> AdamWState:
    """Copy a :func:`flatten_state` map's parameters into ``params`` (in
    place) and return its optimizer state."""
    for n, p in params.items():
        p.copy_(flat[f"params/{n}"])
    return AdamWState(
        step=flat["step"],
        mu={n: flat[f"mu/{n}"] for n in params},
        nu={n: flat[f"nu/{n}"] for n in params},
        norm_ema=flat["norm_ema"],
    )


class TrainRunner:
    def __init__(self, model, data_cfg: DataConfig,
                 train_cfg: TrainConfig = TrainConfig(),
                 runner_cfg: RunnerConfig = RunnerConfig(),
                 mesh=None):
        self.model = model
        self.data_cfg = data_cfg
        self.train_cfg = train_cfg
        self.cfg = runner_cfg
        self.train_step = build_train_step(model, train_cfg, mesh)
        self.history: list[dict] = []

    def run(self, generator: torch.Generator) -> dict:
        """Train from the weights ``generator`` draws, or from the latest
        checkpoint in ``ckpt_dir``; returns the final parameters (the
        model's own tensors), optimizer state and loss, the step it
        resumed from and the logged history."""
        dev = self.model.device
        params, opt_state = init_train_state(self.model, generator)
        start = 0
        resumed = load_latest(self.cfg.ckpt_dir,
                              flatten_state(params, opt_state), device=dev)
        if resumed is not None:
            start, flat, _ = resumed
            opt_state = restore_state(params, flat)
        steps_done = 0
        for step in range(start, self.cfg.total_steps):
            batch = {
                k: torch.as_tensor(v, device=dev)
                for k, v in make_batch(
                    self.model.cfg, self.data_cfg, step
                ).items()
            }
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch
            )
            steps_done += 1
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                self.history.append(
                    {"step": step + 1,
                     "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"])}
                )
            if (step + 1) % self.cfg.ckpt_every == 0:
                save_checkpoint(
                    self.cfg.ckpt_dir, step + 1,
                    flatten_state(params, opt_state),
                    keep_last=self.cfg.keep_last,
                )
            if (self.cfg.crash_after is not None
                    and steps_done >= self.cfg.crash_after):
                raise InjectedFailure(f"injected crash at step {step + 1}")
        final_loss = float(metrics["loss"]) if steps_done else float("nan")
        return {
            "params": params,
            "opt_state": opt_state,
            "final_loss": final_loss,
            "resumed_from": start,
            "history": self.history,
        }
