"""Share (%) of the profiled sub-window in which no operation ran on the
card (throughput cells)."""

from hfxbench.measures import idle_share as read  # noqa: F401
