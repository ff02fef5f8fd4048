"""The paged decode attention kernel's least time over its device time in
the profiled sub-window (%; throughput cells)."""

from hfxbench.measures import paged_decode_roofline as read  # noqa: F401
