"""Mean span of a prefill-chunk step on the host's clock."""

from hfxbench.measures import prefill_ms as read  # noqa: F401
