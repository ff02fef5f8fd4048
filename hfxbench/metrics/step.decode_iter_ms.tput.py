"""Summed span of the decode steps over their iterations (throughput
cells)."""

from hfxbench.measures import decode_iter_ms as read  # noqa: F401
