"""gemma3-4b — 5:1 local:global attention, 128k context, huge vocab.

[hf:google/gemma-3-1b-pt; unverified] 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144.  head_dim=256 (gemma-style, decoupled from
d_model/n_heads).  Sliding window 1024 for local layers.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    tie_embeddings=True,
    window=1024,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt",
)
