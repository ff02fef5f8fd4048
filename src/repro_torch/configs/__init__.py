"""Architecture registry of the port.

It holds every model of the JAX package's registry, field for field,
at full width (:func:`get_config`) and as reduced CPU variants
(:func:`get_smoke_config`): the dense GQA transformers (``qwen7b``,
``qwen32b``, ``llama70b``, ``qwen2.5-14b``, ``internlm2-20b``,
``command-r-plus-104b`` and ``chameleon-34b``, whose VQ image tokens
share the text vocabulary), ``gemma3-4b`` (local windows, so the slot
plane), the MoE models ``olmoe-1b-7b`` and ``phi3.5-moe-42b-a6.6b``,
``mamba2-2.7b`` (Mamba-2 SSD layers), ``zamba2-7b`` (Mamba-2 with a
weight-shared attention block) — and the encoder ``hubert-xlarge``
(bidirectional layers over precomputed audio frames).  As in the JAX
package, :data:`REGISTRY` is the union of the graded pool
(:data:`ASSIGNED_ARCHS`) and the paper's serving models
(:data:`PAPER_MODELS`); the shape suite (:data:`SHAPES`,
``ModelConfig.shapes()``, :func:`mfu_flops`) comes with them.
"""

from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    command_r_plus_104b,
    gemma3_4b,
    hubert_xlarge,
    internlm2_20b,
    llama70b,
    mamba2_2p7b,
    olmoe_1b_7b,
    phi3p5_moe_42b,
    qwen2p5_14b,
    qwen7b,
    qwen32b,
    zamba2_7b,
)
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    mfu_flops,
    reduce_config,
)

# Assigned architecture pool (graded): 10 archs x their shape suites.
ASSIGNED_ARCHS: dict[str, ModelConfig] = {
    "mamba2-2.7b": mamba2_2p7b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3p5_moe_42b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "gemma3-4b": gemma3_4b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "qwen2.5-14b": qwen2p5_14b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
}

# The paper's own serving models (used by the HyperFlexis benchmarks).
PAPER_MODELS: dict[str, ModelConfig] = {
    "qwen7b": qwen7b.CONFIG,
    "qwen32b": qwen32b.CONFIG,
    "llama70b": llama70b.CONFIG,
}

REGISTRY: dict[str, ModelConfig] = {**ASSIGNED_ARCHS, **PAPER_MODELS}


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
    "ASSIGNED_ARCHS",
    "PAPER_MODELS",
    "REGISTRY",
    "SHAPES",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeSpec",
    "get_config",
    "get_smoke_config",
    "mfu_flops",
    "reduce_config",
]
