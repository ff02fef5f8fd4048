"""Mean time (ms) a request due in the window spent in the engine's
queue, its ``request.queue`` spans summed."""

from hfxbench.spans import queue_wait_ms as read  # noqa: F401
