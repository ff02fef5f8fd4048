"""The benchmark's weights, and the port's model and engine built on them.

The weights are the benchmark's own: drawn from ``--seed`` on the device
by one generator, a tensor per kind of weight in the order and with the
stds that the configuration's family (``families/<family>.py``) gives
(a few large calls, in the dtype they are served in), and handed both to
the port and to the reference.  The port's ``Model`` is built on the
``meta`` device from the family's config and takes the family's views
of the weights by assignment, so the card holds one copy.
"""

from __future__ import annotations

from types import ModuleType

import torch

from hfxbench import catalog

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def family(cfg: dict) -> ModuleType:
    """The module of the configuration's family."""
    return catalog.load_module("families", cfg["family"])


def draw_weights(cfg: dict, seed: int, device, into: dict = None) -> dict:
    """The weights of ``seed``, drawn on ``device`` in the config's dtype
    (into the tensors of ``into`` when given, so that a process can
    redraw them for another seed without a second copy)."""
    fam = family(cfg)
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    out = {}
    for name, shape in fam.shapes(cfg).items():
        t = (into[name] if into is not None else
             torch.empty(shape, dtype=dtype, device=device))
        torch.randn(shape, generator=gen, dtype=dtype, device=device, out=t)
        out[name] = t.mul_(fam.std(name, shape))
    return out


def build_model(cfg: dict, weights: dict, device):
    """The port's ``Model`` over ``weights`` (no copy): built on ``meta``
    and given each layer's view.  The model keeps the device it was
    built for, which the engine reads for its caches: it is set to the
    weights' device."""
    from repro_torch.models.build import Model

    fam = family(cfg)
    model = Model(fam.port_config(cfg), dtype=DTYPES[cfg["dtype"]],
                  device="meta", use_kernels=True)
    model.load_state_dict(fam.state_dict(cfg, weights), strict=True,
                          assign=True)
    model.device = torch.device(device)
    return model


def build_engine(model, cfg: dict):
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    return InferenceEngine(model, EngineConfig(**cfg["engine"]))
