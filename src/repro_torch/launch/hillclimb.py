"""Automated §Perf hillclimb (counterpart of
``repro/launch/hillclimb.py`` over the port's meta-device dry run).

Runs a cell's baseline plus a set of candidate option-variants, compares
the three roofline terms, and prints the hypothesis log table:

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --arch command-r-plus-104b --shape decode_32k \
        --variants no-fsdp,q-chunk=2048

Known variant knobs: no-fsdp, no-remat, no-residual-shard, compress,
train-kv-repeat, q-chunk=<n>, pad-heads=<n>, moe-groups=<n>.
"""

import argparse
import json
import os


def parse_variant(spec: str) -> dict:
    kw: dict = {}
    for part in spec.split("+"):
        part = part.strip()
        if not part:
            continue
        if part == "no-fsdp":
            kw["fsdp"] = False
        elif part == "no-remat":
            kw["remat"] = False
        elif part == "no-residual-shard":
            kw["shard_residual"] = False
        elif part == "compress":
            kw["compress"] = True
        elif part == "train-kv-repeat":
            kw["train_kv_repeat"] = True
        elif part.startswith("q-chunk="):
            kw["q_chunk"] = int(part.split("=")[1])
        elif part.startswith("pad-heads="):
            kw["pad_heads"] = int(part.split("=")[1])
        elif part.startswith("moe-groups="):
            kw["moe_groups"] = int(part.split("=")[1])
        else:
            raise ValueError(f"unknown variant knob {part!r}")
    return kw


def fmt(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def main(argv=None) -> None:
    from repro_torch.launch.dryrun import run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variants", default="",
                    help="comma-separated variant specs; '+' combines "
                         "knobs within one variant")
    ap.add_argument("--out", default="runs/hillclimb.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    specs = ["baseline"] + [v for v in args.variants.split(",") if v]
    with open(args.out, "a") as f:
        for spec in specs:
            kw = {} if spec == "baseline" else parse_variant(spec)
            rec = run_cell(args.arch, args.shape, args.mesh, **kw)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            rows.append((spec, rec))
            if rec["status"] != "ok":
                print(f"[FAIL] {spec}: {rec.get('error', '')[:160]}")

    base = rows[0][1]
    print(f"\n## {args.arch} x {args.shape} x {args.mesh}\n")
    print("| variant | compute | memory | collective | bottleneck |"
          " useful | vs-baseline dominant |")
    print("|---|---|---|---|---|---|---|")
    for spec, r in rows:
        if r["status"] != "ok":
            continue
        if base["status"] == "ok" and base["bottleneck"] in (
            "compute", "memory", "collective"
        ):
            dom_key = f"{base['bottleneck']}_term_s"
            ratio = (base[dom_key] / r[dom_key]
                     if r.get(dom_key) else float("nan"))
            delta = f"{ratio:.2f}x"
        else:
            delta = "-"
        print(f"| {spec} | {fmt(r['compute_term_s'])} "
              f"| {fmt(r['memory_term_s'])} "
              f"| {fmt(r['collective_term_s'])} "
              f"| {r['bottleneck']} "
              f"| {r['useful_flops_ratio']:.2f} | {delta} |")


if __name__ == "__main__":
    main()
