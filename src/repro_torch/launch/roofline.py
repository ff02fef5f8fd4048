"""Roofline report generator: dryrun.jsonl -> markdown table (copy of
``repro/launch/roofline.py`` over the records of
:mod:`repro_torch.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.roofline --in runs/dryrun.jsonl

``bytes/dev`` sums the record's ``memory`` entries: the port's records
hold argument and output bytes and no temp bytes (``memory_method``).
"""

from __future__ import annotations

import argparse
import json
from collections import OrderedDict


_DEFAULT_OPTIONS = {
    "compress": False, "fsdp": True, "remat": True,
    "shard_residual": None, "q_chunk": 512, "unroll": True,
    "pad_heads": 0, "moe_groups": 0, "train_kv_repeat": False,
}


def nondefault_options(options: dict) -> dict:
    return {
        k: v for k, v in (options or {}).items()
        if _DEFAULT_OPTIONS.get(k, object()) != v
    }


def is_baseline(rec: dict) -> bool:
    return not nondefault_options(rec.get("options", {}))


def load(path: str) -> list[dict]:
    recs = OrderedDict()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (r.get("arch"), r.get("shape"), r.get("mesh"),
                   json.dumps(nondefault_options(r.get("options", {})),
                              sort_keys=True))
            recs[key] = r  # later lines win (re-runs)
    return list(recs.values())


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def table(recs: list[dict], mesh: str = "single",
          baseline_only: bool = True) -> str:
    rows = [r for r in recs if r.get("mesh") == mesh
            and r.get("status") == "ok"
            and (is_baseline(r) or not baseline_only)]
    out = [
        "| arch | shape | compute | memory | collective | bottleneck |"
        " useful | roofline-frac | bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        mem = r.get("memory", {})
        dev_bytes = (mem.get("argument_bytes", 0)
                     + mem.get("temp_bytes", 0)
                     + mem.get("output_bytes", 0))
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_s(r['compute_term_s'])} "
            f"| {fmt_s(r['memory_term_s'])} "
            f"| {fmt_s(r['collective_term_s'])} "
            f"| {r['bottleneck']} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2f} "
            f"| {dev_bytes/1e9:.2f}GB |"
        )
    return "\n".join(out)


def failures(recs: list[dict]) -> str:
    rows = [r for r in recs if r.get("status") != "ok"]
    if not rows:
        return "(none)"
    return "\n".join(
        f"- {r['arch']} x {r['shape']} x {r['mesh']}: "
        f"{r.get('error', '?')[:160]}"
        for r in rows
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="runs/dryrun.jsonl")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    recs = load(args.inp)
    print(f"## Roofline ({args.mesh}-pod)\n")
    print(table(recs, args.mesh))
    print("\n### Failures\n")
    print(failures(recs))


if __name__ == "__main__":
    main()
