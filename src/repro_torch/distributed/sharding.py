"""Logical-axis sharding rules (counterpart of
``repro/distributed/sharding.py``).

Models name the dims of their parameters, caches and activations with
*logical* axes; an :class:`AxisRules` maps each logical name to the
physical mesh axes it is split over.  The JAX package hands the rules to
XLA's SPMD partitioner; the port has no partitioner, so here the rules
are a plan: :meth:`AxisRules.spec` gives a tensor's per-dim mesh axes
and :meth:`AxisRules.shard_shape` the shape each device holds, which is
what the meta-device dry run (:mod:`repro_torch.launch.dryrun`) counts.

A mesh is anything with axis names and sizes: a
:class:`repro_torch.launch.mesh.MeshSpec` (``axis_names``, ``shape`` as
a dict) or a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names``, ``shape`` as a tuple) — all JAX's functions read of
a mesh is ``mesh.shape`` and ``mesh.axis_names``.
:func:`baseline_rules`, :func:`plan_arch` and :func:`arch_rules` are
JAX's, line for line.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

Axis = Union[str, Sequence[str], None]

# Logical axes used across the codebase:
#   batch      — request/sequence batch dim
#   seq        — token position dim (activations)
#   heads      — attention query heads
#   kv_heads   — attention kv heads (post TP-replication)
#   embed      — d_model activation dim
#   ff         — MLP hidden dim
#   vocab      — vocabulary dim
#   experts    — MoE expert dim
#   layers     — stacked-layer leading dim of scanned params (JAX only:
#                the port's layers are a flat list)
#   fsdp       — the dim of each weight sharded ZeRO-style (params only)
#   ssm_heads  — mamba heads
#   ssm_inner  — mamba d_inner channel dim


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    if mesh is None:
        return {}
    names = getattr(mesh, "axis_names", None)
    if names is None:                       # a DeviceMesh
        names = mesh.mesh_dim_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return {a: int(n) for a, n in zip(names, shape)}


class AxisRules:
    def __init__(self, mapping: dict[str, Axis], mesh=None):
        self.mapping = dict(mapping)
        self.mesh = mesh

    def spec(self, logical: Sequence[Optional[str]]) -> tuple:
        """Per-dim mesh axes of a tensor whose dims are named
        ``logical``: None, one axis name, or a tuple of them (JAX's
        ``PartitionSpec``).  An axis already used by an earlier dim is
        dropped, and trailing Nones are trimmed."""
        phys = []
        used: set[str] = set()
        for name in logical:
            ax = self.mapping.get(name) if name else None
            if ax is None:
                phys.append(None)
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            phys.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        # trim trailing Nones for tidiness
        while phys and phys[-1] is None:
            phys.pop()
        return tuple(phys)

    def shard_shape(self, shape: Sequence[int],
                    logical: Sequence[Optional[str]]) -> tuple:
        """The shape one device holds: each dim divided by the product of
        its mesh axes' sizes, rounded up (XLA pads an uneven shard)."""
        sizes = mesh_sizes(self.mesh)
        spec = self.spec(logical)
        out = []
        for i, n in enumerate(shape):
            part = spec[i] if i < len(spec) else None
            ways = _axis_size(sizes, part)
            out.append(-(-int(n) // ways))
        return tuple(out)


_tls = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def constrain(x, *logical: Optional[str]):
    """JAX's sharding constraint by logical axis names.  The port places
    nothing (one card holds the whole tensor), so it returns ``x``."""
    return x


# ---------------------------------------------------------------------------
# Canonical rule sets
# ---------------------------------------------------------------------------


def baseline_rules(mesh, *, fsdp: bool = True,
                   shard_seq: bool = False,
                   exclude_pod: bool = False) -> AxisRules:
    """Paper-faithful baseline: DP over ('pod','data'), TP over 'model'.

    ``fsdp=True`` additionally shards one non-TP dim of every weight over
    the data axis (ZeRO-3 style); ``shard_seq`` moves activation sequence
    sharding onto the data axis (used when batch < data axis size, e.g.
    long_500k decode, and for sequence-parallel prefill).
    ``exclude_pod`` removes 'pod' from the data axes — required when the
    pod-axis gradient sync runs manually (compressed cross-pod DP).
    """
    names = ("data",) if exclude_pod else ("pod", "data")
    data_axes = tuple(a for a in names if a in mesh_sizes(mesh))
    mapping: dict[str, Axis] = {
        "batch": data_axes,
        "seq": data_axes if shard_seq else None,
        "heads": "model",
        "kv_heads": "model",
        "embed": None,
        "residual": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "layers": None,
        "fsdp": data_axes if fsdp else None,
        "ssm_heads": "model",
        "ssm_inner": "model",
        "heads_fused": "model",
        "kv_fused": "model",
        "qblocks": None,
        "cache_seq": None,
        "moe_group": None,
    }
    return AxisRules(mapping, mesh)


def _axis_size(mesh, names) -> int:
    """Product of the sizes of mesh axes ``names`` (None: 1); ``mesh`` is
    a mesh or its :func:`mesh_sizes` dict."""
    if names is None:
        return 1
    sizes = mesh if isinstance(mesh, dict) else mesh_sizes(mesh)
    names = (names,) if isinstance(names, str) else names
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def plan_arch(cfg, mesh) -> dict:
    """Divisibility-driven sharding decisions for one architecture.

    Returns {kv_repeat, heads_sharded, vocab_pad} — the knobs the
    launcher must apply consistently to the Model and the AxisRules.
    """
    m = mesh_sizes(mesh)["model"]
    heads_ok = cfg.n_heads > 0 and cfg.n_heads % m == 0
    kv_repeat = 1
    if heads_ok and cfg.n_kv_heads > 0:
        if cfg.n_kv_heads % m == 0:
            kv_repeat = 1
        elif m % cfg.n_kv_heads == 0:
            kv_repeat = m // cfg.n_kv_heads
            # GQA grouping must stay integral after repetition
            if cfg.n_heads % (cfg.n_kv_heads * kv_repeat) != 0:
                kv_repeat = 1
    kv_eff = max(cfg.n_kv_heads, 1) * kv_repeat
    kv_sharded = heads_ok and kv_eff % m == 0
    vocab_pad = 0
    if cfg.vocab_size % m != 0 and cfg.vocab_size > 10_000:
        vocab_pad = (-cfg.vocab_size) % m
    return {
        "heads_sharded": heads_ok,
        "kv_repeat": kv_repeat,
        "kv_sharded": kv_sharded,
        "vocab_pad": vocab_pad,
    }


def arch_rules(cfg, mesh, *, stage: str = "train",
               fsdp: bool = True, exclude_pod: bool = False,
               shard_residual: Optional[bool] = None,
               batch_size: Optional[int] = None) -> AxisRules:
    """AxisRules specialized to one architecture + execution stage.

    stage: "train" | "prefill" | "decode" | "decode_long".
    Every mapping degrades to None when the dimension does not divide
    the target axis, so lowering always succeeds; the roofline then
    shows the replication cost (e.g. gemma3's 8 heads on a 16-way model
    axis fall back to sequence-parallel attention via 'qblocks').
    """
    plan = plan_arch(cfg, mesh)
    sizes = mesh_sizes(mesh)
    m = sizes["model"]
    rules = baseline_rules(mesh, fsdp=fsdp, exclude_pod=exclude_pod)
    mp = rules.mapping
    data_axes = mp["batch"]

    heads = "model" if plan["heads_sharded"] else None
    mp["heads"] = heads
    mp["heads_fused"] = heads
    mp["kv_heads"] = "model" if plan["kv_sharded"] else None
    mp["kv_fused"] = ("model" if (plan["kv_sharded"]
                                  and plan["kv_repeat"] == 1) else None)
    mp["qblocks"] = None if plan["heads_sharded"] else "model"
    mp["vocab"] = ("model"
                   if (cfg.vocab_size + plan["vocab_pad"]) % m == 0
                   else None)
    mp["ff"] = "model" if (cfg.d_ff == 0 or cfg.d_ff % m == 0) else None
    if cfg.moe is not None:
        mp["experts"] = ("model" if cfg.moe.num_experts % m == 0 else None)
        mp["ff"] = ("model" if cfg.moe.expert_d_ff % m == 0 else mp["ff"])
        if cfg.moe.dispatch_groups:
            # grouped dispatch: groups shard over data AND model; expert
            # compute is fully shard-local, expert weights are gathered
            # (ZeRO-style, fsdp axis) instead of tokens being scattered
            base = mp["batch"] if isinstance(mp["batch"], tuple) else (
                (mp["batch"],) if mp["batch"] else ())
            mp["moe_group"] = tuple(base) + ("model",)
            mp["experts"] = None
            mp["ff"] = None
    if cfg.ssm is not None:
        di = cfg.ssm.d_inner(cfg.d_model)
        h = cfg.ssm.n_heads(cfg.d_model)
        mp["ssm_inner"] = "model" if di % m == 0 else None
        mp["ssm_heads"] = "model" if h % m == 0 else None
    # fsdp viability: every fsdp'd dim here is d_model or expert d_model
    if cfg.d_model % _axis_size(sizes, mp["fsdp"]) != 0:
        mp["fsdp"] = None

    if batch_size is not None and data_axes:
        if batch_size % _axis_size(sizes, data_axes) != 0:
            # drop pod first, then give up on batch sharding
            if (len(data_axes) > 1
                    and batch_size % sizes[data_axes[-1]] == 0):
                mp["batch"] = (data_axes[-1],)
            else:
                mp["batch"] = None

    if shard_residual is None:
        shard_residual = stage == "train"
    mp["residual"] = ("model" if (shard_residual and cfg.d_model % m == 0)
                      else None)

    if stage == "decode_long":
        # batch=1: shard the KV/state sequence dim instead
        mp["batch"] = None
        mp["cache_seq"] = tuple(
            a for a in (("data",) if exclude_pod else ("pod", "data"))
            if a in sizes
        ) + ("model",)
    elif stage == "decode":
        mp["cache_seq"] = "model"  # dropped per-tensor when kv uses it
        mp["residual"] = None
    return rules
