"""chameleon-34b — early-fusion VLM, VQ image tokens in a shared vocab.

[arXiv:2405.09818; unverified] 48L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536.

The modality frontend is a stub, as in the JAX package: image patches
are pre-quantized to VQ token ids living in the same 65,536-entry
vocabulary, so the model takes ordinary int32 token streams (mixed
text + image-token spans) and the backbone is a standard causal LM.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    frontend="token+vq",
    source="arXiv:2405.09818",
)
