"""qwen32b — the paper's mid-size serving model (TP=2 in the paper)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-32B (paper serving model)",
)
