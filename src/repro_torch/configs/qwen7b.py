"""qwen7b — the paper's smallest serving model (TP=1 in the paper)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen-7B (paper serving model)",
)
