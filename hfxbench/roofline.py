"""Peaks of the card, and the least time a step's work can take on it.

Peaks: NVIDIA's H100 SXM5 data sheet, dense (no sparsity): 989 TFLOP/s
in bf16, 3.35 TB/s of HBM3.  A card set below its 700 W limit runs
slower under load; the run prints the limit beside its numbers.

The operations and bytes of a step are counted from shapes alone by the
configuration's family (``families/<family>.py``, its ``counts(cfg)``),
by these rules: the model's own work for the tokens that are real, not
what the program computes (a prefill step's padding lanes and a decode
pass's idle rows count nothing), and each input byte once per step
(weights, the K and V a token attends to), whatever the program reads
again, so a time these give is a lower bound.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


def causal_keys(start: int, take: int) -> int:
    """Keys attended by the queries at positions start .. start+take-1
    (a query at position p sees p + 1 of them)."""
    return take * start + take * (take + 1) // 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S)
