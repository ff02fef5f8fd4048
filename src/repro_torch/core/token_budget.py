"""Token budget n_token (paper Eq. 5 / Appendix B).

The budget bounds how many *prompt* tokens a worker can accept so that,
in the worst case (a request arriving right after a dispatch), the
prefill stall amortized over decode iterations still meets the tightest
TTFT/TPOT at the worker:

    n_token <= (TTFT*TPOT - TTFT*E_d - a*TPOT) / (b*TPOT)

where (a, b) are the prefill-model coefficients and E_d the estimated
per-iteration decode cost of ongoing requests.

A copy of ``repro/core/token_budget.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.latency_model import LatencyModel


def ntoken_limit(ttft: float, tpot: float, e_d: float,
                 model: LatencyModel) -> int:
    """Eq. 5.  Returns 0 when the worker cannot take any prompt tokens."""
    if tpot <= e_d:
        # No decode slack: any prefill stall would violate TPOT.
        return 0
    a, b = model.a, model.b
    if b <= 0:
        return 1_000_000_000
    n = (ttft * tpot - ttft * e_d - a * tpot) / (b * tpot)
    return max(0, int(n))


def chunk_schedule(l_in: int, chunk_tokens: Optional[int]) -> list[int]:
    """Split a prompt into bounded prefill chunks (last may be short).

    The per-chunk bound is how both execution planes (engine and
    simulator) keep a long prompt's prefill stall inside the Eq. 5
    decode slack: each chunk interleaves with one decode iteration.
    ``chunk_tokens`` None (or >= l_in) degenerates to monolithic.
    """
    if l_in <= 0:
        return []
    if chunk_tokens is None or chunk_tokens >= l_in:
        return [l_in]
    assert chunk_tokens > 0
    full, rem = divmod(l_in, chunk_tokens)
    return [chunk_tokens] * full + ([rem] if rem else [])


def maturity_interval(e_p: float, e_d: float, min_tpot: float) -> float:
    """Worker 'next maturity' advance (Algorithm 1 last lines).

    relax = min TPOT among (waiting + new + running) minus E_d is the
    per-iteration slack; the prefill stall E_p is amortized over
    E_p / relax iterations, each costing E_d.
    """
    relax = min_tpot - e_d
    if relax <= 1e-9:
        # no slack: the worker must drain decode before new prefill
        return e_p + 100.0 * e_d
    return e_p + (e_p / relax) * e_d
