"""P/D-disaggregated serving on the PyTorch port: two-stage scheduling +
fast scaling.

The port's counterpart of ``examples/pd_disaggregated.py``:
- the Dispatcher schedules prefill instances (Algorithm 1);
- the Migrator picks decode instances *after* prefill completes and the
  TLManager moves the KV cache over D2D links;
- the Scaler grows/shrinks pools, flips worker roles, and provisions new
  instances via Fast Scaling (D2D weight pull) vs disk loading.

Two execution planes behind the same control plane:

    # discrete-event simulator (paper-scale workloads; no device)
    PYTHONPATH=src python examples/pd_disaggregated_torch.py

    # the port's engines on the card: prefill on engine A, paged KV
    # exported, installed on engine B, decode continues token-identically
    PYTHONPATH=src python examples/pd_disaggregated_torch.py \
        --backend engine --smoke [--device cpu]

The engine plane runs on the CUDA card unless ``--device`` names another
(it raises without a card); the ``Cluster`` draws its seed weights on
the device from its config's seed (``models.build.seeded_model``).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.request import FOUR_TASK_SET
from repro_torch.core.scaler import ScalerConfig
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.workload import poisson_workload


def run(label, smoke=False, **kw):
    if smoke:
        reqs = poisson_workload(FOUR_TASK_SET, qps=96, n_per_task=3,
                                seed=3)
    else:
        reqs = poisson_workload(FOUR_TASK_SET, qps=96, n_per_task=100,
                                seed=3)
    cfg = ClusterConfig(model=get_config("qwen7b"), mode="pd",
                        n_prefill=2, n_decode=2, seed=3, **kw)
    res = Cluster(cfg).run(reqs)
    m = res.metrics
    print(f"{label:28s} att={m.attainment:.3f} e2e={m.mean_e2e:.2f}s "
          f"cost={m.cost_units:.0f} kv_transfers={res.kv_transfers} "
          f"role_flips={res.n_role_flips} scale_out={res.n_scale_out}")
    for t, wid, ev in res.timeline[:6]:
        print(f"    t={t:7.2f}s worker{wid}: {ev}")
    return m


def run_engine(smoke=True, device="cuda") -> dict:
    """Engine plane: the Migrator moves REAL paged KV between
    InferenceEngine replicas (export_kv -> TLManager-costed transfer
    -> import_kv), measured payload bytes and all."""
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.workload import engine_smoke_workload

    reqs = engine_smoke_workload(n=8 if smoke else 24, seed=3)
    cfg = ClusterConfig(
        model=get_smoke_config("qwen7b"), backend="engine",
        policy="hyperflexis", mode="pd", n_prefill=1, n_decode=1,
        seed=3, engine=EngineConfig.smoke(),
    )
    cluster = Cluster(cfg, device=device)
    res = cluster.run(reqs)
    m = res.metrics
    print(f"{'engine-pd':28s} finished={m.n_finished}/{m.n_total} "
          f"kv_transfers={res.kv_transfers} "
          f"kv_bytes={cluster.tl.kv_bytes_moved:.0f}")
    moved = [r for r in reqs if r.decode_worker is not None
             and r.decode_worker != r.prefill_worker]
    print(f"    {len(moved)} requests prefilled on worker 0, decoded on "
          f"worker 1 after a real paged-KV hand-off")
    assert m.n_finished == m.n_total
    return {
        "served": m.n_finished,
        "total": m.n_total,
        "kv_transfers": res.kv_transfers,
        "kv_bytes": cluster.tl.kv_bytes_moved,
        "moved": sorted(r.rid for r in moved),
        "tokens": {r.rid: list(r.generated) for r in reqs},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="sim", choices=["sim", "engine"])
    ap.add_argument("--smoke", action="store_true",
                    help="small workload (CI / CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="device of the engine plane (default: the card)")
    args = ap.parse_args(argv)

    if args.backend == "engine":
        print("== engine-plane P/D (real paged-KV migration)")
        return run_engine(smoke=args.smoke, device=args.device)
    out = {}
    print("== one-shot RR-PD (the anti-pattern §5.1 fixes)")
    out["rr-pd one-shot"] = run("rr-pd one-shot", smoke=args.smoke,
                                policy="rr", one_shot_pd=True)
    print("== HyperFlexis-PD (two-stage Dispatcher + Migrator)")
    out["hfx-pd"] = run("hfx-pd", smoke=args.smoke, policy="hyperflexis")
    print("== HyperFlexis-PD + scaling (fast D2D weight transfer)")
    out["hfx-pd-scaling d2d"] = run(
        "hfx-pd-scaling d2d", smoke=args.smoke, policy="hyperflexis",
        scaling=True,
        scaler=ScalerConfig(max_workers=8, weight_strategy="d2d"))
    print("== same but disk cold-start (slow scaling)")
    out["hfx-pd-scaling disk"] = run(
        "hfx-pd-scaling disk", smoke=args.smoke, policy="hyperflexis",
        scaling=True,
        scaler=ScalerConfig(max_workers=8, weight_strategy="disk"))
    return {"served": sum(m.n_finished for m in out.values()),
            "total": sum(m.n_total for m in out.values())}


if __name__ == "__main__":
    main()
