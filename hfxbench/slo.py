"""Latency and SLO arithmetic over the open loop's wall-clock stamps.

Copied from the port so that later changes to the program cannot move
the yardstick: a request's TTFT and TPOT and whether it met its task's
SLOs are ``core/request.py``'s ``ttft`` / ``tpot`` / ``ttft_ok`` /
``tpot_ok`` / ``attained`` (a TPOT of 0 for a single token, a 1e-9
slack on each limit), attainment counts every request of the
denominator that did not finish as a miss (``serving/metrics.py``'s
``compute_metrics``), and tails are ``np.percentile``'s linear
interpolation, as there.  The stamps here are the client's: a request's
TTFT runs from when it was due, and a token counts when the ``step()``
that produced it returns.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from hfxbench.traffic import Req


def percentile(values: Sequence[float], q: float) -> float:
    return float(np.percentile(values, q)) if len(values) else math.nan


def ttft(r: Req, end: float) -> float:
    """From due to first token; a request still without one at the end
    of the run counts the time it had waited."""
    return (r.first if r.first is not None else end) - r.due


def tpot(r: Req) -> Optional[float]:
    if not r.finished:
        return None
    n = len(r.tokens)
    if n <= 1:
        return 0.0
    return (r.last - r.first) / (n - 1)


def attained(r: Req) -> bool:
    t = tpot(r)
    return (r.first is not None and t is not None
            and r.first - r.due <= r.ttft_slo + 1e-9
            and t <= r.tpot_slo + 1e-9)


def attainment(reqs: Sequence[Req]) -> float:
    return sum(attained(r) for r in reqs) / max(len(reqs), 1)
