"""Find a cell's knee: the highest offered rate at which the backlog
does not grow over the window.

    python3 hfxbench/sweep.py --workload <cell> --rates 1.2,1.6,2.0 --seconds 30 --seed <n>

One process sets up once and serves the cell's mix at each rate in
turn, on a fresh engine each time, with no pre-roll and no drain.  One
JSON line per rate on standard output: the backlog (requests due and
not finished) at half the window and at its close, TTFT p90 over the
requests due in the first half (a request still waiting counts its
wait), output tokens per second, and the steps by kind.  A cell's rate
is fixed in its file from one such sweep; this does not run in the
benchmark's runs.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def backlog(reqs, t: float) -> int:
    return sum(r.due <= t and not (r.finished and r.last <= t) for r in reqs)


def sweep(cell: dict, cfg: dict, mix: dict, rates, seconds: float,
          seed: int, device):
    """Yield one dict per rate (see the module's doc)."""
    from hfxbench import harness, model, slo

    cell = {**cell, "judge": "throughput", "preroll_s": 0.0}
    weights = model.draw_weights(cfg, seed, device)
    mdl = model.build_model(cfg, weights, device)
    w = seconds
    for rate in rates:
        engine = harness.warm_up(mdl, cfg, seed, None)
        reqs, steps, _, _, at_close = harness.window(
            {**cell, "rate_rps": rate}, engine, mix, cfg, seed=seed,
            seconds=w, sub=None, device=device)
        del engine
        early = [r for r in reqs if r.due < w / 2]
        kinds = {}
        for s in steps:
            kinds[s.kind] = kinds.get(s.kind, 0) + 1
        yield {"rate_rps": rate, "n": len(reqs),
               "backlog_half": backlog(reqs, w / 2),
               "backlog_end": backlog(reqs, w),
               "ttft_p90_s_first_half": slo.percentile(
                   [slo.ttft(r, w) for r in early], 90),
               "output_tok_s": sum(s.emitted for s in steps if s.t1 < w) / w,
               "finished": sum(r.finished for r in reqs),
               "at_close": at_close, "steps": kinds}


def main(argv=None) -> int:
    import argparse
    import json

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from hfxbench import catalog

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    cell, cfg, mix = catalog.resolve(args.workload)
    print(f"sweep {args.workload} on {torch.cuda.get_device_name(0)}",
          file=sys.stderr)
    for row in sweep(cell, cfg, mix, [float(x) for x in args.rates.split(",")],
                     args.seconds, args.seed, "cuda:0"):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
