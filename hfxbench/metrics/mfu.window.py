"""Every step's least time on the card over the window's seconds (%)."""

from hfxbench.measures import mfu_window as read  # noqa: F401
