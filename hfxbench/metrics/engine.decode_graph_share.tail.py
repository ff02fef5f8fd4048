"""Share (%) of the decode iterations that replayed the captured decode
graph (their dispatch's ``graph``; tail cells)."""

from hfxbench.spans import decode_graph_share as read  # noqa: F401
