"""mamba2-2.7b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 64L d_model=2560 vocab=50280 ssm_state=128.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk_size=256),
    source="arXiv:2405.21060",
)
