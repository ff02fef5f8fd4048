"""Share (%) of the profiled sub-window the card stood idle outside every
engine span: the harness's loop (throughput cells)."""

from hfxbench.spans import idle_outside_engine as read  # noqa: F401
