"""80th percentile, over the window's finished requests of two tokens or
more, of (last token - first token) / (tokens - 1)."""

from hfxbench.measures import tpot_tail


def read(run):
    return tpot_tail(run, 80)
