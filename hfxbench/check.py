"""Whether what the timed path served is right.

Once the window has closed and the program's state is freed, a sample
of the finished requests, drawn from the seed, is replayed through the
plain reference: each prompt with the tokens the engine served for it.
At the position before each served token the reference's logits say
how far that token's logit lies below the best one; the number compared
is the widest such gap over the sample.  A greedy engine that computes
what the model says serves, at every position, the reference's best
token or one within its own rounding of it.  The sample always holds
the request with the most served tokens and the one with the longest
prompt (the one that took the most prefill chunks), then requests in a
seeded order until it holds ``sample_tokens`` served tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from hfxbench import catalog
from hfxbench.traffic import Req, rng_for


def sample(finished: list[Req], seed: int, sample_tokens: int) -> list[Req]:
    if not finished:
        return []
    picked = [max(finished, key=lambda r: (len(r.tokens), -r.rid)),
              max(finished, key=lambda r: (r.l_in, -r.rid))]
    picked = list({r.rid: r for r in picked}.values())
    rest = [r for r in finished if r not in picked]
    for i in rng_for(seed, 3).permutation(len(rest)):
        if sum(len(r.tokens) for r in picked) >= sample_tokens:
            break
        picked.append(rest[i])
    return picked


def scored(reqs: list[Req]) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(sequence fed, tokens scored) of each request: the prompt and all
    served tokens but the last; the served tokens, each judged at the
    position before it."""
    seqs = [np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
            for r in reqs]
    return seqs, [np.asarray(r.tokens, np.int64) for r in reqs]


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """Over the positions, the widest gap between the best logit and
    the logit of ``tokens``; inf where a logit is not finite."""
    best = ref_logits.max(-1).values
    gap = best - ref_logits.gather(-1, tokens[:, None])[:, 0]
    return float(gap.max()) if torch.isfinite(gap).all() else float("inf")


@torch.no_grad()
def served_gap(weights: dict, cfg: dict, reqs: list[Req], device,
               controls: tuple = ()) -> dict:
    """The widest gap of the served tokens (``program``) and, for each
    precision in ``controls``, of the tokens that precision would put
    first at the same positions."""
    ref = catalog.load_module("reference", cfg["reference"])
    seqs, toks = scored(reqs)
    hidden = ref.final_hidden(weights, cfg, seqs, ["f32", *controls], device)
    out = {"program": 0.0, **{c: 0.0 for c in controls}}
    for i, t in enumerate(toks):
        p = len(reqs[i].prompt) - 1
        logit = ref.logits(weights, hidden["f32"][i][p:])
        t = torch.as_tensor(t, device=logit.device)
        out["program"] = max(out["program"], widest_gap(logit, t))
        for c in controls:
            pick = ref.logits(weights, hidden[c][i][p:], c).argmax(-1)
            out[c] = max(out[c], widest_gap(logit, pick))
        del logit
    return out


def judge(weights: dict, cfg: dict, cell: dict, reqs: list[Req],
          mismatches: int, seed: int, device) -> tuple[bool, dict, int]:
    """(correct, the numbers compared with their limits, served tokens
    compared).  ``mismatches`` counts requests whose served stream is
    not what the engine recorded for them, or which the engine finished
    at another length than asked."""
    picked = sample([r for r in reqs if r.finished], seed,
                    cell["check"]["sample_tokens"])
    gap = (served_gap(weights, cfg, picked, device)["program"]
           if picked else float("inf"))
    compared = {
        "logit_gap_max": {"value": gap,
                          "limit": cell["check"]["limit_logit_gap"]},
        "stream_mismatches": {"value": mismatches, "limit": 0},
    }
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared, sum(len(r.tokens) for r in picked)
