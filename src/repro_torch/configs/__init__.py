"""Architecture registry of the port.

It holds only what the port runs, at full width (:func:`get_config`)
and as reduced CPU variants (:func:`get_smoke_config`): ``qwen7b`` (the
paged plane), ``gemma3-4b`` (local windows, so the slot plane),
``mamba2-2.7b`` (Mamba-2 SSD layers) and ``zamba2-7b`` (Mamba-2 with a
weight-shared attention block), the last two on both planes.  Other
architectures join as their ROADMAP items land.
"""

from __future__ import annotations

from repro_torch.configs import gemma3_4b, mamba2_2p7b, qwen7b, zamba2_7b
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    reduce_config,
)

REGISTRY: dict[str, ModelConfig] = {
    "qwen7b": qwen7b.CONFIG,
    "gemma3-4b": gemma3_4b.CONFIG,
    "mamba2-2.7b": mamba2_2p7b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; the port knows "
            f"{sorted(REGISTRY)}"
        ) from None


def get_smoke_config(name: str) -> ModelConfig:
    return reduce_config(get_config(name))


__all__ = [
    "REGISTRY",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "get_smoke_config",
    "reduce_config",
]
