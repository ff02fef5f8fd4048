"""SLO-customized speculative decoding (model-free drafter + controller).

Two pieces the engine (and the sim plane's mirror) share:

- :class:`NGramDrafter` — prompt-lookup / n-gram proposal over each
  request's ``prompt + generated`` token history.  No second model: the
  drafter finds the latest earlier occurrence of the trailing n-gram
  and proposes its historical continuation.  Fully deterministic, so
  proposals are seed-stable and the greedy verify step keeps token
  identity with plain decode (rejected proposals are rolled back).

- :func:`slo_spec_len` — the per-lane speculation-length controller.
  AdaServe's observation, grounded in the paper's Eq. 5 machinery: the
  right speculation depth is a function of the request's TPOT *slack*.
  A depth-``k`` propose-verify dispatch costs roughly
  ``E_d + b * k`` (one decode step plus ``k`` extra verify lanes at the
  prefill per-token rate ``b``) and in the worst case (nothing
  accepted) still emits one token — so the deepest K that cannot break
  the request's TPOT even on a total miss is

      K = floor((tpot_slo - E_d) / b)

  clamped to ``[0, max_spec_len]``.  Tight-slack requests speculate
  conservatively (or not at all); loose-slack requests go deep.  Both
  planes call this with the same :class:`FittedLatencyModel`, so the
  Dispatcher/Scaler see one throughput model.

A copy of ``repro/serving/spec_decode.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Knobs shared by the engine drafter and the sim mirror."""

    max_spec_len: int = 8      # proposal-depth ceiling per lane
    max_ngram: int = 3         # longest trailing n-gram to look up
    min_ngram: int = 1
    # controller depth before the profiler has fitted (Eq. 5 needs
    # coefficients): conservative, never zero — some speculation is how
    # acceptance statistics start accumulating
    unfitted_default: int = 2


class NGramDrafter:
    """Prompt-lookup drafter: propose the continuation that followed
    the most recent earlier occurrence of the current trailing n-gram.

    Greedy decode loops and template-heavy prompts repeat themselves;
    whenever the history has seen the current context before, the
    recorded continuation is a strong draft.  Lookup prefers longer
    n-grams (more specific context) and, within an n-gram length, the
    *latest* earlier match (most recent regime).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}..{max_ngram}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing ``history`` (1-D int
        token ids, prompt + generated).  Deterministic; returns [] when
        no earlier occurrence of any trailing n-gram exists."""
        if k <= 0:
            return []
        h = np.asarray(history, np.int64)
        n_hist = int(h.shape[0])
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            tail = h[n_hist - n:]
            # candidate starts whose n-gram ends strictly before the
            # history's end (the tail itself is excluded)
            starts = np.flatnonzero(h[: n_hist - n] == tail[0])
            match = None
            for i in starts[::-1]:          # latest match first
                if np.array_equal(h[i: i + n], tail):
                    match = int(i)
                    break
            if match is None:
                continue
            out = h[match + n: match + n + k]
            if out.size:
                return [int(x) for x in out]
        return []


def slo_spec_len(tpot_slo: float, model, cur_lens: Sequence[int],
                 cfg: SpecConfig) -> int:
    """Speculation depth for one lane from its Eq. 5 / TPOT slack.

    ``model`` is the shared (Fitted)LatencyModel: ``E_d`` comes from
    Eq. 2 over the current batch lengths and ``b`` (the prefill
    per-token coefficient) prices each extra verify lane.  Worst-case
    guarantee: a dispatch at the returned depth emits >= 1 token in at
    most ``tpot_slo`` seconds even when every proposal is rejected.
    """
    if cfg.max_spec_len <= 0:
        return 0
    if not getattr(model, "fitted", True):
        return min(cfg.unfitted_default, cfg.max_spec_len)
    e_d = model.decode_step_time(list(cur_lens))
    slack = tpot_slo - e_d
    if slack <= 0.0:
        return 0
    b = max(float(model.b), 1e-12)
    return int(min(slack / b, cfg.max_spec_len))


def expected_emitted(k: int, accept_rate: float) -> float:
    """Expected tokens emitted by one depth-``k`` propose-verify
    dispatch under i.i.d. per-token acceptance probability
    ``accept_rate`` (geometric longest-prefix): 1 + sum_{i=1..k} a^i.

    The sim plane scales its decode ticks by this so the Dispatcher /
    Scaler see the same acceptance-rate-scaled throughput model the
    engine plane measures.
    """
    k = max(0, int(k))
    a = min(max(float(accept_rate), 0.0), 1.0)
    if k == 0:
        return 1.0
    if a >= 1.0:
        return 1.0 + k
    return 1.0 + a * (1.0 - a ** k) / (1.0 - a)
