"""Model FLOPs of the real prompt tokens prefilled over 989 TFLOP/s times
the prefill steps' summed span (%)."""

from hfxbench.measures import mfu_prefill as read  # noqa: F401
