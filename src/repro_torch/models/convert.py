"""Load the JAX package's parameter tree into the port's :class:`Model`.

``repro.models.build.Model.init(key)`` builds a tree whose per-layer
leaves are stacked along a leading layer dim
(``segments[0]["attn"]["wq"]`` is ``(L, d, Hq*hd)``).  The caller turns
it into numpy (``jax.tree.map(np.asarray, params)``) — this module
imports no JAX — and :func:`params_from_jax` returns the matching
``state_dict`` for ``Model.load_state_dict``.  Both sides keep the
``(in, out)`` weight layout, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def params_from_jax(tree, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Map every leaf of the JAX tree to the port's parameter name(s).

    Top-level leaves (``embed``, ``head``, ``final_norm``) map to one
    tensor each; a stacked layer leaf maps to ``cfg.n_layers`` tensors,
    one per ``layers.{i}.…``.  Raises on a leaf with no counterpart, on
    a stacked leaf whose lead dim is not ``n_layers``, and on two leaves
    that would land on one name, so each JAX leaf is used exactly once.
    """
    if cfg.layer_pattern() != (("dense", cfg.n_layers),):
        raise NotImplementedError(
            f"{cfg.name}: only single dense-segment models are ported"
        )
    out: dict[str, torch.Tensor] = {}

    def put(name, arr):
        if name in out:
            raise ValueError(f"two JAX leaves map to {name}")
        out[name] = torch.tensor(np.asarray(arr))

    for path, leaf in _leaves(tree):
        arr = np.asarray(leaf)
        if path in (("embed",), ("head",), ("final_norm",)):
            put(path[0], arr)
        elif path[:2] == ("segments", 0) and (
                path[2:3] in (("ln1",), ("ln2",)) and len(path) == 3
                or path[2:3] in (("attn",), ("ffn",)) and len(path) == 4):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(
                    f"{'/'.join(map(str, path))}: lead dim {arr.shape[0]} "
                    f"!= n_layers {cfg.n_layers}"
                )
            rest = ".".join(str(p) for p in path[2:])
            for i in range(cfg.n_layers):
                put(f"layers.{i}.{rest}", arr[i])
        else:
            raise ValueError(
                f"JAX leaf {'/'.join(map(str, path))} has no counterpart "
                f"in the port's Model"
            )
    return out
