"""Real prompt tokens over the lanes the prefill chunks computed (%; the
chunk dispatches' ``tokens`` and ``lanes``)."""

from hfxbench.spans import prefill_lane_use as read  # noqa: F401
