"""Stage latency models (paper Eq. 1, Eq. 2, Appendix A).

    E_p = a + b * sum(l_in) + c * sum(l_in^2)        (prefill batch)
    E_d = a' + b' * sum(l_cur) + c' * B              (one decode step)

A copy of the coefficient classes of ``repro/core/latency_model.py``:
:class:`LatencyModel` evaluates Eq. 1/2 from coefficients, and
:class:`FittedLatencyModel` is the paper's profiler — a least-squares
fit from measured (lengths, time) samples.  The roofline ground truth
and its hardware constants are not copied: the card's own figures come
with the scaler slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class LatencyCoeffs:
    a: float   # prefill fixed overhead (s)
    b: float   # prefill per-token (s)
    c: float   # prefill per-token^2 (s)
    a_d: float  # decode fixed per step (s)
    b_d: float  # decode per cached token (s)
    c_d: float  # decode per sequence in batch (s)


class LatencyModel:
    """Eq. 1 / Eq. 2 evaluation given coefficients."""

    def __init__(self, coeffs: LatencyCoeffs):
        self.coeffs = coeffs

    def prefill_time(self, lens: Sequence[int]) -> float:
        if not len(lens):
            return 0.0
        k = self.coeffs
        s1 = float(sum(lens))
        s2 = float(sum(x * x for x in lens))
        return k.a + k.b * s1 + k.c * s2

    def decode_step_time(self, cur_lens: Sequence[int]) -> float:
        if not len(cur_lens):
            return 0.0
        k = self.coeffs
        return k.a_d + k.b_d * float(sum(cur_lens)) + k.c_d * len(cur_lens)

    # Convenience for Eq. 5 (token budget) — a, b of the prefill model.
    @property
    def a(self) -> float:
        return self.coeffs.a

    @property
    def b(self) -> float:
        return self.coeffs.b


class FittedLatencyModel(LatencyModel):
    """Least-squares fit from profiled samples (Appendix A)."""

    def __init__(self):
        super().__init__(LatencyCoeffs(0.0, 1e-4, 0.0, 0.0, 1e-6, 0.0))
        self._p_samples: list[tuple[float, float, float]] = []
        self._d_samples: list[tuple[float, float, float]] = []
        self.fitted = False

    def observe_prefill(self, lens: Sequence[int], t: float) -> None:
        s1 = float(sum(lens))
        s2 = float(sum(x * x for x in lens))
        self._p_samples.append((s1, s2, t))

    def observe_decode(self, cur_lens: Sequence[int], t: float) -> None:
        self._d_samples.append(
            (float(sum(cur_lens)), float(len(cur_lens)), t)
        )

    def observe_decode_block(self, lens_per_iter: Sequence[Sequence[int]],
                             t: float) -> None:
        """Attribute one fused K-iteration decode block (wall time
        ``t``) as per-iteration Eq. 2 samples of ``t / K`` each.
        Trailing all-empty iterations are trimmed before dividing, so
        wall time is attributed to emitted tokens only; interior empty
        iterations carry no sample."""
        k = len(lens_per_iter)
        while k > 0 and not lens_per_iter[k - 1]:
            k -= 1
        if k == 0:
            return
        per = t / k
        for lens in lens_per_iter[:k]:
            if lens:
                self.observe_decode(lens, per)

    def fit(self, min_samples: int = 8) -> bool:
        ok = True
        if len(self._p_samples) >= min_samples:
            arr = np.asarray(self._p_samples)
            x = np.stack(
                [np.ones(len(arr)), arr[:, 0], arr[:, 1]], axis=1
            )
            # minimize squared *relative* error (paper App. A): weight rows
            w = 1.0 / np.maximum(arr[:, 2], 1e-6)
            sol, *_ = np.linalg.lstsq(
                x * w[:, None], arr[:, 2] * w, rcond=None
            )
            a, b, c = [max(0.0, float(v)) for v in sol]
            self.coeffs.a, self.coeffs.b, self.coeffs.c = a, b, c
        else:
            ok = False
        if len(self._d_samples) >= min_samples:
            arr = np.asarray(self._d_samples)
            x = np.stack(
                [np.ones(len(arr)), arr[:, 0], arr[:, 1]], axis=1
            )
            w = 1.0 / np.maximum(arr[:, 2], 1e-6)
            sol, *_ = np.linalg.lstsq(
                x * w[:, None], arr[:, 2] * w, rcond=None
            )
            a_d, b_d, c_d = [max(0.0, float(v)) for v in sol]
            self.coeffs.a_d, self.coeffs.b_d, self.coeffs.c_d = (
                a_d, b_d, c_d
            )
        else:
            ok = False
        self.fitted = ok
        return ok
