"""olmoe-1b-7b — 64 experts, top-8 MoE.

[arXiv:2409.02060; hf] 16L d_model=2048 16H (kv=16) expert_d_ff=1024
vocab=50304, MoE 64e top-8.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, expert_d_ff=1024),
    source="arXiv:2409.02060",
)
