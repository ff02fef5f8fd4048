"""Share (%) of the profiled sub-window the card stood idle while the host
was inside ``engine.dispatch`` (tail cells)."""

from hfxbench.spans import idle_in_dispatch as read  # noqa: F401
