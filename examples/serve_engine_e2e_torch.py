"""End-to-end driver of the PyTorch port: serve a small model with batched
requests.

The port's counterpart of ``examples/serve_engine_e2e.py``.  Runs the
port's engine (continuous batching, paged KV cache with chunked prefill
— or the slot plane for ring-cache archs such as gemma3, greedy
sampling) over a request stream with heterogeneous SLOs, using the Eq. 5
token-budget admission fit live from the engine's own profiler.  Final
metrics come from the same `compute_metrics` the simulator uses.

It runs on the CUDA card unless ``--device`` names another (it raises
without a card).  The weights are drawn on the device from a seeded
generator (``models.build.seeded_model``).

    PYTHONPATH=src python examples/serve_engine_e2e_torch.py --arch gemma3-4b
    PYTHONPATH=src python examples/serve_engine_e2e_torch.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.request import TASKS, Request
from repro_torch.models import build
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.metrics import compute_metrics


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen7b")
    ap.add_argument("--n-requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    device = resolve_device(args.device)
    model = build.seeded_model(cfg, device, 0)
    engine = InferenceEngine(
        model,
        EngineConfig(n_slots=args.slots, max_len=96, prefill_batch=2,
                     slo_aware=True),
    )
    rng = np.random.default_rng(0)
    tasks = list(TASKS.values())[:4]
    reqs = []
    for i in range(args.n_requests):
        spec = tasks[i % len(tasks)]
        l_in = max(2, min(32, int(rng.normal(12, 4))))
        reqs.append(Request.from_prompt(
            i,
            rng.integers(0, cfg.vocab_size, size=l_in).astype(np.int32),
            max_new=int(rng.integers(4, 12)),
            task=spec.name, ttft_slo=spec.ttft_slo,
            tpot_slo=spec.tpot_slo,
        ))
    for r in reqs:
        engine.submit(r)
    steps = 0
    while engine.queue or engine.prefilling or engine.active:
        info = engine.step()
        steps += 1
        if steps % 20 == 0:
            print(f"  step {steps}: {info['kind']} "
                  f"active={len(engine.active)} "
                  f"queued={len(engine.queue)} "
                  f"clock={engine.clock:.2f}s")
        if steps % 25 == 0:
            engine.fit_profiler()  # refresh Eq.1/2 online
    done = [r for r in reqs if r.finish_time is not None]
    print(f"served {len(done)}/{len(reqs)} in {steps} steps, "
          f"clock={engine.clock:.2f}s")
    ttfts = [r.ttft for r in done]
    print(f"TTFT: mean={np.mean(ttfts):.3f}s p99="
          f"{np.percentile(ttfts, 99):.3f}s")
    tok = sum(len(r.generated) for r in done)
    print(f"throughput: {tok/engine.clock:.1f} tok/s (virtual clock)")
    # shared metrics path: identical RunMetrics schema to the simulator
    m = compute_metrics(reqs, cost_units=engine.clock, makespan=engine.clock)
    for task, v in m.per_task.items():
        print(f"  {task:20s} att={v['attainment']:.2f} "
              f"(ttft {v['ttft_attainment']:.2f} / "
              f"tpot {v['tpot_attainment']:.2f}) n={v['n']}")
    return {
        "served": len(done),
        "total": len(reqs),
        "paged": engine.paged,
        "tokens": {r.rid: list(r.generated) for r in reqs},
    }


if __name__ == "__main__":
    main()
