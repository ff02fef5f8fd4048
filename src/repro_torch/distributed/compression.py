"""Gradient compression for the cross-pod (slow-link) boundary
(counterpart of ``repro/distributed/compression.py``).

The pod-axis gradient sync quantizes each gradient to int8 steps of a
per-tensor scale that all pods share:

    s = max|g| / 127                 (per tensor, all-reduced max)
    q = round(g / s)                 (in [-127, 127])
    all_reduce(q) over 'pod'  ->  int32, exact
    g_hat = q_sum * s / n_pods

What crosses the pods is ``q`` as int32, 4 bytes an element (as the JAX
code psums it), plus one f32 max per tensor: the same bytes as the f32
gradient.  ``compress_residual`` returns the residual ``g - q * s`` that
error feedback would carry into the next step.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` play the part of JAX's ``mesh.axis_names``.  Each
rank is one pod: it differentiates the contiguous block of the batch's
leading rows at its ``pod`` coordinate, as ``shard_map``'s
``in_specs=P("pod")`` splits the batch, and the ``pod`` dimension's
process group carries the sync, one gradient tensor at a time (the
transient memory is one tensor's int32 copy).  A leaf is what shares a
scale: JAX stacks a parameter over the layers of a segment into one
leaf, the port keeps a tensor a layer, so the caller names the tensors
of each leaf.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_residual(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Returns (q, scale, residual) with residual = g - dequant(q)."""
    q, s = quantize(g)
    return q, s, g - dequantize(q, s)


@contextlib.contextmanager
def _grads_on(leaves):
    """Gradients on for ``leaves`` (and autograd on) for the length of
    the block; off again after it."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield
    finally:
        for p in leaves:
            p.requires_grad_(False)


def value_and_grad(loss_fn):
    """The counterpart of ``jax.value_and_grad(loss_fn)`` for
    ``loss_fn(params, batch)``, ``params`` a tensor or a dict of tensors:
    returns (the detached loss, gradients shaped as ``params``).  A
    tensor no gradient reaches gets zeros, as ``jax.grad`` gives it."""
    def vg(params, batch):
        named = params if isinstance(params, dict) else {None: params}
        leaves = list(named.values())
        with _grads_on(leaves):
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if isinstance(params, dict):
            return loss.detach(), dict(zip(named, grads))
        return loss.detach(), grads[0]

    return vg


def _psum_quantized(grads: dict, names, group) -> None:
    """Exact-sum int8 quantized all-reduce over ``group`` of the tensors
    ``grads[names]``, one leaf: they share one scale, the max |g| over
    all of them and across the group (which keeps the sum exact).  Each
    result replaces its tensor in ``grads``, one at a time."""
    gmax = torch.stack([grads[n].float().abs().max() for n in names]).max()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(gmax / 127.0, min=1e-12)
    n_pods = dist.get_world_size(group)
    for name in names:
        g = grads[name]
        q = torch.div(g.float(), scale).round_().clamp_(-127, 127).to(
            torch.int32)
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        grads[name] = q.float().mul_(scale).div_(n_pods).to(g.dtype)


def _pmean(g: torch.Tensor, group) -> torch.Tensor:
    """The f32 mean of ``g`` over ``group``, in ``g``'s dtype (summed in
    place when ``g`` is f32)."""
    g32 = g.float()
    dist.all_reduce(g32, op=dist.ReduceOp.SUM, group=group)
    return g32.div_(dist.get_world_size(group)).to(g.dtype)


def _pod_block(batch, pod: int, n: int):
    """This pod's contiguous block of leading rows of every tensor of
    ``batch`` (a tensor or a dict of tensors)."""
    def block(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{n} pods")
        return x[pod * (b // n):(pod + 1) * (b // n)]

    if isinstance(batch, dict):
        return {k: block(v) for k, v in batch.items()}
    return block(batch)


def sync_pod_grads(grads, group, *, compress: bool = True, leaves=None):
    """Sum ``grads`` (a tensor or a dict of tensors) over the pods of
    ``group`` and divide by their count: as int8 steps with one scale a
    leaf (``compress``), else in f32.  ``leaves`` lists the names of a
    dict whose gradients share one scale, as one stacked leaf of a JAX
    tree does (``models.convert.stacked_leaves``); by default each
    tensor is a leaf.  A dict is updated in place, one tensor at a
    time; returns the synced gradients."""
    named = grads if isinstance(grads, dict) else {None: grads}
    if compress:
        for names in leaves or [[k] for k in named]:
            _psum_quantized(named, names, group)
    else:
        for k in named:
            named[k] = _pmean(named[k], group)
    return named if isinstance(grads, dict) else named[None]


def pod_manual_value_and_grad(loss_fn, mesh, *, compress: bool = True,
                              leaves=None):
    """Build a value_and_grad of ``loss_fn(params, batch)`` whose
    *pod-axis* gradient sync is manual (and optionally int8-compressed).

    Each rank differentiates its pod's whole block of the batch; then
    the gradients are synced over the ``pod`` group
    (:func:`sync_pod_grads`, ``compress`` and ``leaves`` as there) and
    the loss is averaged over the pods.  Parameters are pod-replicated:
    every rank passes the same ``params``.  On a mesh with ``data`` or
    ``model`` > 1, those ranks of a pod compute the same block: JAX's
    SPMD result inside the ``shard_map`` over ``pod``, computed
    replicated, and so exact for any loss.  Splitting the block over
    ``data`` with a mean over the data group would be exact only for a
    plain mean over equal rows, not for a loss divided by each block's
    own mask count (hubert) or MoE's balance loss and capacity.
    Without a ``pod`` dimension in the mesh this is the plain
    value_and_grad.
    """
    vg = value_and_grad(loss_fn)
    if "pod" not in (mesh.mesh_dim_names or ()):
        return vg
    group = mesh.get_group("pod")
    pod = mesh.get_local_rank("pod")
    n = dist.get_world_size(group)

    def per_pod(params, batch):
        loss, grads = vg(params, _pod_block(batch, pod, n))
        grads = sync_pod_grads(grads, group, compress=compress,
                               leaves=leaves)
        return _pmean(loss, group), grads

    return per_pod
