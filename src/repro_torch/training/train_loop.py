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

With ``grad_compression`` and a mesh (a ``DeviceMesh``) with a ``pod``
dimension, the step syncs the gradients over the pods as int8 steps
(:mod:`repro_torch.distributed.compression`); every other mesh axis
has nothing to do on one rank, as the port has no SPMD partitioner.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.distributed import compression
from repro_torch.models.convert import stacked_leaves
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
)

_MESH_ITEM = "ROADMAP.md §1 item 11 (running a data or model mesh)"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    micro_batches: int = 1
    grad_compression: bool = False  # manual int8 pod-axis grad sync


def trained_params(model) -> dict:
    """The tree a train step updates: the model's own parameters, by
    name (in ``named_parameters`` order)."""
    return dict(model.named_parameters())


def value_and_grad(model, params: dict, batch: dict):
    """(loss, grads) of ``model.loss(batch)`` with respect to
    ``params``, which must be the model's own parameters.  A parameter
    no gradient reaches (a frames model's ``embed``) gets zeros, as
    ``jax.grad`` gives it."""
    return compression.value_and_grad(_model_loss(model))(params, batch)


def _model_loss(model):
    """``model.loss`` as a loss of (params, batch), where ``params`` must
    be the model's own parameters: the model reads them itself."""
    def loss(params, batch):
        own = trained_params(model)
        if own.keys() != params.keys() or any(
                params[n] is not p for n, p in own.items()):
            raise ValueError("params must be the model's own parameters "
                             "(trained_params(model))")
        return model.loss(batch)

    return loss


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
    ``skipped``).  ``batch`` holds tensors on the model's device.

    With ``cfg.grad_compression`` and a ``pod`` dimension in ``mesh``
    (a ``DeviceMesh``), each rank differentiates its pod's block of the
    global batch and the gradients are summed over the pods as int8
    steps (``pod_manual_value_and_grad``), one scale for each leaf of
    the JAX tree (``stacked_leaves``: a parameter stacked over a
    segment's layers is one leaf); that path ignores
    ``cfg.micro_batches``, as JAX's does.  Otherwise the step is the
    micro-batch or the plain one, whatever the mesh.  A mesh whose
    ``data`` or ``model`` dimension is larger than 1 raises: its plans
    exist (``distributed/sharding.py``), but running them needs a
    gradient mean over the data group and tensor parallelism, which JAX
    gets from its SPMD partitioner and the port does not have yet."""
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    for axis in ("data", "model"):
        if axis in names and mesh.size(names.index(axis)) > 1:
            raise NotImplementedError(
                f"a mesh with {axis} > 1 is planned "
                f"(repro_torch.distributed.sharding) but not run: it needs "
                f"a gradient mean over the data group and tensor "
                f"parallelism ({_MESH_ITEM})")
    vg = None
    if cfg.grad_compression and "pod" in names:
        vg = compression.pod_manual_value_and_grad(
            _model_loss(model), mesh, compress=True,
            leaves=stacked_leaves(model.cfg, trained_params(model)))

    def train_step(params, opt_state: AdamWState, batch):
        if vg is not None:
            loss, grads = vg(params, batch)
        elif cfg.micro_batches > 1:
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
