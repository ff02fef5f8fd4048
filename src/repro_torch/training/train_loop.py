"""The train step of the port (counterpart of
``repro/training/train_loop.py``): the value and gradient of
``Model.loss``, micro-batch gradient accumulation, and AdamW.

The trained tree is the model's own parameters
(:func:`trained_params`): they are built with ``requires_grad=False``,
so serving never records a graph, and :func:`value_and_grad` turns
gradients on for them for the length of one ``loss`` call.  AdamW then
updates them in place.  The model should be built with
``use_kernels=False``, as the JAX trainer's ``build_model(cfg,
remat=True)`` is: no kernel has a backward in either package (the ops
wrappers raise rather than cut a gradient).

The JAX package's manual int8 cross-pod gradient sync
(``grad_compression`` over a mesh's ``pod`` axis) is not ported:
passing a mesh raises, naming its ROADMAP item.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
)

_MESH_ITEM = "ROADMAP.md §1 item 8 'Distributed + launch tooling'"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    micro_batches: int = 1
    grad_compression: bool = False  # manual int8 pod-axis grad sync


def trained_params(model) -> dict:
    """The tree a train step updates: the model's own parameters, by
    name (in ``named_parameters`` order)."""
    return dict(model.named_parameters())


@contextlib.contextmanager
def _grads_on(leaves):
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield
    finally:
        for p in leaves:
            p.requires_grad_(False)


def value_and_grad(model, params: dict, batch: dict):
    """(loss, grads) of ``model.loss(batch)`` with respect to
    ``params``, which must be the model's own parameters.  A parameter
    no gradient reaches (a frames model's ``embed``) gets zeros, as
    ``jax.grad`` gives it."""
    own = trained_params(model)
    if own.keys() != params.keys() or any(
            params[n] is not p for n, p in own.items()):
        raise ValueError("params must be the model's own parameters "
                         "(trained_params(model))")
    leaves = list(params.values())
    with _grads_on(leaves):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(params.items(), grads)}


def _accumulate_grads(model, params: dict, batch: dict, n_micro: int):
    """Gradient accumulation over micro-batches (activation memory
    ~1/n): f32 sums of the losses and gradients, scaled by 1/n."""
    def split(x):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    micro = {k: split(v) for k, v in batch.items()}
    grads_acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                 for n, p in params.items()}
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
    for i in range(n_micro):
        loss, grads = value_and_grad(model, params,
                                     {k: v[i] for k, v in micro.items()})
        for n, g in grads.items():
            grads_acc[n] += g.float()
        loss_acc = loss_acc + loss
        del grads
    inv = 1.0 / n_micro
    for g in grads_acc.values():
        g.mul_(inv)
    return loss_acc * inv, grads_acc


def build_train_step(model, cfg: TrainConfig = TrainConfig(),
                     mesh: Optional[Any] = None):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics): ``params`` (the model's own, see
    :func:`trained_params`) and the optimizer's moments are updated in
    place; metrics holds 0-d tensors (``loss``, ``grad_norm``, ``lr``,
    ``skipped``).  ``batch`` holds tensors on the model's device."""
    if mesh is not None:
        raise NotImplementedError(
            f"training over a device mesh is not ported ({_MESH_ITEM})")

    def train_step(params, opt_state: AdamWState, batch):
        if cfg.micro_batches > 1:
            loss, grads = _accumulate_grads(model, params, batch,
                                            cfg.micro_batches)
        else:
            loss, grads = value_and_grad(model, params, batch)
        params, opt_state, stats = adamw_update(cfg.adamw, grads, opt_state,
                                                params)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def init_train_state(model, generator: torch.Generator
                     ) -> tuple[dict, AdamWState]:
    """Draw the model's weights from ``generator`` (``Model.init``) and
    return (its parameters, a fresh AdamW state)."""
    model.init(generator)
    params = trained_params(model)
    return params, adamw_init(params)
