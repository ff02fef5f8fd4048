"""Real prompt tokens per prefill-chunk step (the step's ``tokens``)."""

from hfxbench.measures import prefill_tokens_per_step as read  # noqa: F401
