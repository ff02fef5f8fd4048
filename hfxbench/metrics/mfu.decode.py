"""Each decode iteration's least time on the card (the larger of its
FLOPs at 989 TFLOP/s and its bytes at 3.35 TB/s), summed, over the
decode steps' summed span (%)."""

from hfxbench.measures import mfu_decode as read  # noqa: F401
