"""Causal (query, key) pairs the prefill chunks' real tokens need over
those their chunk attention scored (%; the dispatches' ``pairs_needed``
and ``pairs``)."""

from hfxbench.spans import prefill_pair_use as read  # noqa: F401
