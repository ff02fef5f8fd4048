"""zamba2-7b — hybrid Mamba2 + weight-shared attention blocks.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (kv=32 — MHA)
d_ff=14336 vocab=32000, ssm_state=64.

Layer pattern: groups of 5 Mamba-2 layers followed by one invocation of a
single *weight-shared* full-attention block (13 invocations), plus a
3-layer Mamba tail: 13*(5+1) + 3 = 81 layers total.  The shared block's
concat-with-embedding input and per-invocation LoRA deltas from the
published model are simplified to a plain shared attention block, as
in the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk_size=256),
    shared_attn_period=5,
    source="arXiv:2411.15242",
)
