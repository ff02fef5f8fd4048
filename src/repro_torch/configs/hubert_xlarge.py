"""hubert-xlarge — encoder-only audio transformer (w2v2 backbone).

[arXiv:2106.07447; unverified] 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (masked-prediction codebook targets).

The audio conv frontend is a stub, as in the JAX package: the model
takes precomputed frame embeddings of shape (batch, frames, d_model);
it is the bidirectional transformer encoder + codebook head.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    frontend="frames",
    source="arXiv:2106.07447",
)
