"""Output tokens delivered to clients inside the window, over the
window's seconds."""

from hfxbench.measures import output_tok_s as read  # noqa: F401
