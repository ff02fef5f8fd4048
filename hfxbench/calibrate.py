"""The readings a cell's correctness limit is set from.

    python3 hfxbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 20

For each seed, in one process: the seed's weights (redrawn into the same
tensors), a warm engine, the cell's schedule over a short window at the
cell's own rate, and the sample the benchmark would judge.  Then the
widest logit gap of the served tokens (``program``: the lower reading)
and, at the same positions of the same prompts and tokens, that of the
tokens the reference computed in float8 e4m3 would put first
(``fp8``, the control: the nearest precision below the configuration's
bfloat16).  One JSON line per seed.  The limit in the cell's file lies
between the largest ``program`` and the smallest ``fp8`` reading; the
benchmark's own runs do not run this.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: dict, cfg: dict, mix: dict, seeds, seconds: float,
             controls: tuple, device):
    """Yield one dict of readings per seed (see the module's doc)."""
    import gc

    import torch

    from hfxbench import check, harness, model

    weights = mdl = None
    for seed in seeds:
        weights = model.draw_weights(cfg, seed, device, into=weights)
        if mdl is None:
            mdl = model.build_model(cfg, weights, device)
        engine = harness.warm_up(mdl, cfg, seed, None)
        reqs, _, end, engine_reqs, at_close = harness.window(
            cell, engine, mix, cfg, seed=seed, seconds=seconds, sub=None,
            device=device)
        bad = harness.mismatches(reqs, engine_reqs)
        del engine
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        picked = check.sample([r for r in reqs if r.finished], seed,
                              cell["check"]["sample_tokens"])
        gaps = check.served_gap(weights, cfg, picked, device, controls)
        yield {"seed": seed, **gaps, "mismatches": bad,
               "requests": len(picked),
               "tokens": sum(len(r.tokens) for r in picked),
               "finished": sum(r.finished for r in reqs), "n": len(reqs),
               "stopped_s": end, "at_close": at_close}


def main(argv=None) -> int:
    import argparse
    import json

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from hfxbench import catalog

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--controls", default="fp8")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell, cfg, mix = catalog.resolve(args.workload)
    print(f"calibrate {args.workload} on {torch.cuda.get_device_name(0)}",
          file=sys.stderr)
    for row in readings(cell, cfg, mix,
                        [int(x) for x in args.seeds.split(",")],
                        args.seconds,
                        tuple(c for c in args.controls.split(",") if c),
                        "cuda:0"):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
