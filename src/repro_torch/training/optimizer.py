"""AdamW of the port (counterpart of ``repro/training/optimizer.py``),
over flat name -> tensor maps (a model's ``named_parameters``).

The arithmetic is the JAX package's: a linear warm-up of the learning
rate, a global-norm clip, the anomaly guard (an EMA of the gradient
norm; a step whose norm exceeds ``anomaly_factor`` times it updates no
parameter, while the moments still decay), bias correction in f32 and
decoupled weight decay on the f32 parameter.  Every quantity stays on
the parameters' device: no step reads a value back to the host.

One difference of form, none of value: :func:`adamw_update` writes the
new parameters and moments into the tensors it is given (a trained
model's parameters must stay its own), where the JAX function returns
new arrays; and the moments are f32 from the start (JAX's begin in the
parameters' dtype and are f32 from the first update on).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # skip the update when the global grad norm spikes (fault tolerance:
    # a straggler-corrupted or loss-spike step should not poison Adam)
    skip_anomalous: bool = True
    anomaly_factor: float = 10.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: dict                # name -> f32 tensor
    nu: dict
    norm_ema: torch.Tensor  # 0-d f32: running grad-norm scale of the guard


def adamw_init(params: dict) -> AdamWState:
    dev = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for n, p in params.items()}

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=zeros(), nu=zeros(),
        norm_ema=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = ((step + 1) / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    return cfg.lr * warm


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState,
                 params: dict):
    """Returns (params, new_state, stats): ``params`` and the moment
    tensors of ``state`` are updated in place; stats holds the 0-d
    tensors ``grad_norm``, ``lr`` and ``skipped`` (1.0 where the guard
    skipped the step)."""
    gnorm = global_norm(grads)
    clip = (cfg.grad_clip / gnorm.clamp(min=1e-9)).clamp(max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)

    ema = torch.where(state.norm_ema == 0.0, gnorm,
                      0.99 * state.norm_ema + 0.01 * gnorm)
    ok = gnorm <= cfg.anomaly_factor * ema.clamp(min=1e-9)
    if not cfg.skip_anomalous:
        ok = torch.ones_like(ok)
    scale = torch.where(ok, clip, torch.zeros_like(clip))  # skip: no-op

    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    for name, p in params.items():
        g = grads[name].float() * scale
        m = cfg.b1 * state.mu[name] + (1 - cfg.b1) * g
        v = cfg.b2 * state.nu[name] + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.float()
        p_new = p32 - lr * (delta + cfg.weight_decay * p32)
        p.copy_(torch.where(ok, p_new, p32))
        state.mu[name].copy_(m)
        state.nu[name].copy_(v)
    stats = {"grad_norm": gnorm, "lr": lr, "skipped": (~ok).float()}
    return params, AdamWState(step, state.mu, state.nu, ema), stats
