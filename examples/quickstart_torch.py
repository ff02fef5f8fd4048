"""Quickstart of the PyTorch port: the layers of the framework on one card.

The port's counterpart of ``examples/quickstart.py``, stage for stage:

1. Build a (reduced) model from the architecture registry and serve a
   few batched requests through the port's inference engine (continuous
   batching + paged KV cache + Eq.5 admission).
2. Fit the Eq.1/Eq.2 latency predictor from the engine's measured step
   times (the paper's profiler).
3. Run the multi-SLO cluster simulation with the HyperFlexis scheduler.
4. Run the SAME control plane (Dispatcher, Algorithm 1) engine-backed:
   `Cluster(backend="engine")` drives real compute on the device.

The engine stages run on the CUDA card unless ``--device`` names
another (they raise without a card); stage 3 needs no device.  The
weights are drawn on the device from a seeded generator
(``models.build.seeded_model``; stage 4's ``Cluster`` draws its own from
its config's seed the same way).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.request import FOUR_TASK_SET, Request
from repro_torch.models import build
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.workload import poisson_workload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the engine stages (default: the card)")
    args = ap.parse_args(argv)

    # --- 1. real engine on a reduced qwen7b ------------------------------
    cfg = get_smoke_config("qwen7b")
    device = resolve_device(args.device)
    model = build.seeded_model(cfg, device, 0)
    engine = InferenceEngine(
        model, EngineConfig(n_slots=4, max_len=64, prefill_batch=2)
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request.from_prompt(
            i,
            rng.integers(0, cfg.vocab_size,
                         size=int(rng.integers(4, 16))).astype(np.int32),
            max_new=8, ttft_slo=1.0, tpot_slo=0.5)
        for i in range(8)
    ]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    print(f"engine: served {len(reqs)} requests, "
          f"virtual clock {engine.clock:.2f}s")
    print(f"  first generation: {reqs[0].generated}")

    # --- 2. latency predictor from measured steps -------------------------
    engine.fit_profiler()
    c = engine.profiler.coeffs
    print(f"fitted Eq.1/2: E_p = {c.a:.4f} + {c.b:.2e}*sum(l) "
          f"+ {c.c:.2e}*sum(l^2);  E_d = {c.a_d:.4f} + "
          f"{c.b_d:.2e}*sum(l_cur) + {c.c_d:.2e}*B")

    # --- 3. multi-SLO cluster with Algorithm 1 ----------------------------
    workload = poisson_workload(FOUR_TASK_SET, qps=64, n_per_task=50,
                                seed=0)
    res = Cluster(ClusterConfig(model=get_config("qwen7b"),
                                n_workers=2,
                                policy="hyperflexis")).run(workload)
    m = res.metrics
    print(f"cluster[sim]: attainment={m.attainment:.3f} "
          f"mean_e2e={m.mean_e2e:.2f}s cost={m.cost_units:.0f} units")

    # --- 4. the same control plane over the REAL engine -------------------
    ereqs = []
    t = 0.0
    for i in range(10):
        t += float(rng.exponential(0.05))
        ereqs.append(Request(
            rid=i, task="chat" if i % 2 == 0 else "doc", arrival=t,
            l_in=int(rng.integers(4, 14)), l_out=int(rng.integers(2, 6)),
            ttft_slo=0.8 if i % 2 == 0 else 4.0,
            tpot_slo=0.3 if i % 2 == 0 else 0.8,
        ))
    ccfg = ClusterConfig(
        model=cfg, backend="engine", n_workers=1, policy="hyperflexis",
        engine=EngineConfig(n_slots=4, max_len=48, prefill_batch=2),
    )
    res = Cluster(ccfg, device=device).run(ereqs)
    em = res.metrics
    print(f"cluster[engine]: served {em.n_finished}/{em.n_total} "
          f"attainment={em.attainment:.3f} makespan={em.makespan:.2f}s")
    for task, v in em.per_task.items():
        print(f"    {task:6s} ttft_att={v['ttft_attainment']:.2f} "
              f"tpot_att={v['tpot_attainment']:.2f}")
    return {
        "served": sum(r.finish_time is not None for r in reqs)
        + em.n_finished,
        "total": len(reqs) + em.n_total,
        "tokens": {r.rid: list(r.generated) for r in reqs},
        "cluster_served": em.n_finished,
        "cluster_total": em.n_total,
        "cluster_tokens": {r.rid: list(r.generated or []) for r in ereqs},
    }


if __name__ == "__main__":
    main()
