"""Token budget n_token (paper Eq. 5 / Appendix B).

The budget bounds how many *prompt* tokens a worker can accept so that,
in the worst case (a request arriving right after a dispatch), the
prefill stall amortized over decode iterations still meets the tightest
TTFT/TPOT at the worker:

    n_token <= (TTFT*TPOT - TTFT*E_d - a*TPOT) / (b*TPOT)

where (a, b) are the prefill-model coefficients and E_d the estimated
per-iteration decode cost of ongoing requests.
"""

from __future__ import annotations

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
