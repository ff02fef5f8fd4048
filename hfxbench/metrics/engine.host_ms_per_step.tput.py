"""Mean time (ms) of an engine step outside its dispatch and its wait for
the card: scheduling and commit (throughput cells)."""

from hfxbench.spans import host_ms_per_step as read  # noqa: F401
