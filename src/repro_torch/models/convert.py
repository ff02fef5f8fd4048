"""Load the JAX package's parameter tree into the port's :class:`Model`.

``repro.models.build.Model.init(key)`` builds one subtree per *segment*
(``repro/models/build.py::build_segments``):

- a uniform segment of ``count`` layers stacks each leaf along one lead
  dim: ``segments[i]["attn"]["wq"]`` is ``(count, d, Hq*hd)``;
- a **group** segment (a periodic pattern: gemma3's 5 local : 1 global,
  zamba2's 5 mamba : 1 shared attention) holds one subtree per inner
  kind whose leaves carry two lead dims, ``(n_groups, inner_count, …)``:
  ``segments[0]["local"]["attn"]["wq"]`` is ``(5, 5, d, Hq*hd)`` for
  gemma3 at full width, ``segments[0]["mamba"]["mamba"]["w_x"]``
  ``(13, 5, d, d_inner)`` for zamba2.  A ``shared_attn`` kind has no
  leaves: every invocation runs the one top-level ``shared`` block
  (``ln1``, ``ln2``, ``attn``, ``ffn``), which maps to the port's
  ``shared.…``.

The port's layers are one flat list in execution order — group g, then
its inner kinds in order, then the segments after the group — so leaf
``[g, j]`` of inner kind ``kind`` is layer ``offset + g * period +
inner_offset(kind) + j``.  The caller turns the JAX tree into numpy
(``jax.tree.map(np.asarray, params)``) — this module imports no JAX —
and :func:`params_from_jax` returns the matching ``state_dict`` for
``Model.load_state_dict``.  Both sides keep the ``(in, out)`` weight
layout, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

# part of a block -> its depth (0: a leaf; 1: a dict of leaves)
_BLOCK_PARTS = {"ln1": 0, "ln2": 0, "attn": 1, "ffn": 1, "moe": 1,
                "ln": 0, "mamba": 1}


def build_segments(cfg: ModelConfig) -> list[tuple]:
    """The JAX package's segment list, as ``(kind, count, inner)``
    (copy of ``repro/models/build.py::build_segments``): a pattern that
    repeats a pair of kinds at least twice from its start becomes one
    ``("group", n_rep, pair)`` segment, followed by the rest."""
    pattern = list(cfg.layer_pattern())
    if len(pattern) >= 4 and pattern[0][0] != pattern[1][0]:
        pair = (pattern[0], pattern[1])
        n_rep = 0
        while (2 * n_rep + 1 < len(pattern)
               and (pattern[2 * n_rep], pattern[2 * n_rep + 1]) == pair):
            n_rep += 1
        if n_rep >= 2:
            return ([("group", n_rep, pair)]
                    + [(k, c, None) for k, c in pattern[2 * n_rep:]])
    return [(k, c, None) for k, c in pattern]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _layer_map(cfg: ModelConfig) -> dict[tuple, tuple]:
    """(segment index, inner kind or None) -> (flat index of each
    stacked entry, in the leaf's row-major lead-dim order; lead shape)."""
    out = {}
    offset = 0
    for si, (kind, count, inner) in enumerate(build_segments(cfg)):
        if kind != "group":
            out[(si, None)] = (list(range(offset, offset + count)), (count,))
            offset += count
            continue
        period = sum(c for _, c in inner)
        inner_off = 0
        for ikind, icount in inner:
            idx = [offset + g * period + inner_off + j
                   for g in range(count) for j in range(icount)]
            out[(si, ikind)] = (idx, (count, icount))
            inner_off += icount
        offset += count * period
    assert offset == cfg.n_layers, (offset, cfg.n_layers)
    return out


def _plan(tree, cfg: ModelConfig):
    """Yield ``(port name, JAX leaf, row)`` for every tensor of the
    port's ``state_dict``: ``row`` is None for a leaf taken whole (the
    top-level ``embed``, ``head``, ``final_norm`` and the ``shared``
    block), else ``(n_lead, i)``: entry ``i`` of the leaf's ``n_lead``
    stacked lead dims, flattened in row-major order.  Raises on a leaf
    with no counterpart and on a stacked leaf whose lead dims do not
    match its segment.  Reads only ``leaf.shape``."""
    layer_map = _layer_map(cfg)
    for path, leaf in _leaves(tree):
        where = "/".join(map(str, path))
        if path in (("embed",), ("head",), ("final_norm",)):
            yield path[0], leaf, None
            continue
        if (path[:1] == ("shared",) and len(path) >= 2
                and path[1] in _BLOCK_PARTS
                and len(path) == 2 + _BLOCK_PARTS[path[1]]):
            yield ".".join(map(str, path)), leaf, None
            continue
        key = part = None
        if path[:1] == ("segments",) and len(path) >= 3:
            si, rest = path[1], path[2:]
            if (si, None) in layer_map:
                key = (si, None)
            elif (si, rest[0]) in layer_map:
                key, rest = (si, rest[0]), rest[1:]
            if key is not None and rest and rest[0] in _BLOCK_PARTS:
                part = rest
        if part is None or len(part) != 1 + _BLOCK_PARTS[part[0]]:
            raise ValueError(
                f"JAX leaf {where} has no counterpart in the port's Model"
            )
        idx, lead = layer_map[key]
        if tuple(leaf.shape[:len(lead)]) != lead:
            raise ValueError(
                f"{where}: lead dims {tuple(leaf.shape[:len(lead)])} != {lead}"
            )
        name = ".".join(part)
        for row, i in enumerate(idx):
            yield f"layers.{i}.{name}", leaf, (len(lead), row)


def param_shapes_from_jax(tree, cfg: ModelConfig) -> dict[str, tuple]:
    """The name and shape of every tensor :func:`params_from_jax` would
    return, from any tree whose leaves have a ``shape`` (such as
    ``jax.eval_shape(model.init, key)``): checks a full-width layout
    without materializing its weights."""
    out: dict[str, tuple] = {}
    for name, leaf, row in _plan(tree, cfg):
        if name in out:
            raise ValueError(f"two JAX leaves map to {name}")
        out[name] = tuple(leaf.shape[row[0]:] if row else leaf.shape)
    return out


def params_from_jax(tree, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Map every leaf of the JAX tree to the port's parameter name(s).

    Top-level leaves (``embed``, ``head``, ``final_norm``) and the leaves
    of the ``shared`` block map to one tensor each; a stacked layer leaf
    maps to one tensor per layer it stacks, ``layers.{i}.…``.  Raises on
    a leaf with no counterpart, on a stacked leaf whose lead dims do not
    match its segment, and on two leaves that would land on one name,
    so each JAX leaf is used exactly once.
    """
    out: dict[str, torch.Tensor] = {}
    for name, leaf, row in _plan(tree, cfg):
        if name in out:
            raise ValueError(f"two JAX leaves map to {name}")
        arr = np.asarray(leaf)
        if row is not None:
            n_lead, i = row
            arr = arr.reshape((-1,) + arr.shape[n_lead:])[i]
        out[name] = torch.tensor(arr)
    return out


def stacked_leaves(cfg: ModelConfig, names) -> list[list[str]]:
    """The port's parameter ``names`` grouped as the JAX tree holds
    them: one list per leaf, with the layers that a segment stacks into
    one leaf together and every other tensor alone."""
    segment = {i: key for key, (idx, _) in _layer_map(cfg).items()
               for i in idx}
    groups: dict = {}
    for name in names:
        key = name
        if name.startswith("layers."):
            _, i, part = name.split(".", 2)
            key = (segment[int(i)], part)
        groups.setdefault(key, []).append(name)
    return list(groups.values())
