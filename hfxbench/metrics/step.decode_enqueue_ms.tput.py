"""The decode steps' summed ``engine.dispatch`` (the host enqueueing the
pass) over their iterations (ms; throughput cells)."""

from hfxbench.spans import decode_enqueue_ms as read  # noqa: F401
