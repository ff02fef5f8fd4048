"""Mean fused iterations K of the decode steps."""

from hfxbench.measures import decode_k_mean as read  # noqa: F401
