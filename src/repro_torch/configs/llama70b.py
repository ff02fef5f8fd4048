"""llama70b — the paper's largest serving model (TP=8 in the paper)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3-70B (paper serving model)",
)
