"""Serving driver of the port: run the HyperFlexis cluster on a workload.

A copy of ``repro/launch/serve.py`` over the port's ``Cluster`` (the
port imports nothing from the JAX package), line for line but for two
things: ``main`` takes ``argv`` (None reads ``sys.argv``), and
``--device`` (default ``cuda``) names the device of the engine plane's
replicas — it runs on the card unless ``--device cpu`` is given, and
raises without a card.  The sim plane needs no device.

    # simulator plane (paper benchmarks)
    PYTHONPATH=src python -m repro_torch.launch.serve --model qwen7b \
        --policy hyperflexis --qps 64 --tasks 4task --workers 2 --scaling

    # ONLINE mode: JSONL requests on stdin -> JSONL stream events on
    # stdout (admitted/rejected/first_token/token/finished + a final
    # summary row).  Request lines:
    #   {"task": "gsm8k", "prompt": [5,3,9], "l_out": 4,
    #    "ttft_slo": 5.0, "tpot_slo": 1.0, "arrival": 0.1}
    # (prompt may be replaced by "l_in" on the sim plane; omitted
    # SLOs default to the task's Table-1 class; omitted arrival means
    # "now")
    printf '%s\n' '{"task":"gsm8k","prompt":[5,3,9,2,7],"l_out":4}' | \
        PYTHONPATH=src python -m repro_torch.launch.serve --online \
        --backend engine --model qwen7b --smoke --workers 1 \
        --engine-max-len 48 --page-size 8 --chunk-size 16 --device cpu

    # real-engine plane: the SAME control plane over real compute
    # (reduced smoke config on the CPU; size --engine-max-len to your
    # workload or clip Table-1 prompt/output lengths to CPU scale)
    PYTHONPATH=src python -m repro_torch.launch.serve --model qwen7b --smoke \
        --backend engine --qps 16 --n-per-task 4 --workers 1 \
        --engine-max-len 96 --clip-prompt 40 --clip-output 8 --json \
        --device cpu

    # engine-plane P/D disaggregation: prefill engines park completed
    # prompts, the Migrator moves REAL paged-KV payloads to decode
    # engines over TLManager-costed (measured-bytes) transfers
    PYTHONPATH=src python -m repro_torch.launch.serve --model qwen7b --smoke \
        --backend engine --mode pd --n-prefill 1 --n-decode 1 \
        --qps 16 --n-per-task 4 --clip-prompt 24 --clip-output 6 \
        --engine-max-len 48 --page-size 8 --chunk-size 16 --json \
        --device cpu

    # the prefix cache and speculative decoding on the engine plane
    PYTHONPATH=src python -m repro_torch.launch.serve --model qwen7b --smoke \
        --backend engine --workload shared-prefix --prefix-len 16 \
        --n-per-task 2 --qps 1 --workers 1 --engine-max-len 64 \
        --page-size 8 --chunk-size 16 --prefix-cache --spec-decode \
        --max-spec-len 2 --json --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.faults import FaultInjector
from repro_torch.core.request import FOUR_TASK_SET, TASKS, TWO_TASK_SET
from repro_torch.core.scaler import ScalerConfig
from repro_torch.core.slo_mapper import PrioritySLOMapper, bands_from_tasks
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.workload import poisson_workload, shared_prefix_workload


def run_online(args, cfg: ClusterConfig) -> None:
    """stdin JSONL requests -> stdout JSONL stream events."""
    from repro_torch.serving.session import ServingSession

    session = ServingSession(
        Cluster(cfg, device=args.device), admission=args.admission,
        clock="wall" if args.wall_clock else "virtual",
        on_event=lambda ev: print(json.dumps(ev.to_json()), flush=True),
    )

    def submit_line(line: str) -> None:
        # a malformed line must not kill the session (every other
        # client's stream dies with it): report a structured error
        # event and keep serving
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request line must be a JSON object")
            spec = TASKS.get(req.get("task", ""))
            ttft = req.get("ttft_slo", spec.ttft_slo if spec else 10.0)
            tpot = req.get("tpot_slo", spec.tpot_slo if spec else 1.0)
            arrival = req.get("arrival")
            if arrival is not None and not args.wall_clock:
                # replay: advance the virtual clock to the stamped
                # arrival so the admission verdict sees the state *at*
                # arrival
                session.run_until(float(arrival))
            session.submit(
                prompt=req.get("prompt"),
                l_in=req.get("l_in"),
                l_out=int(req.get("l_out", 1)),
                task=req.get("task", "default"),
                ttft_slo=float(ttft), tpot_slo=float(tpot),
                arrival=arrival, rid=req.get("rid"),
                priority=req.get("priority"),
            )
        except Exception as e:  # noqa: BLE001 — structured, not fatal
            print(json.dumps({
                "event": "error",
                "reason": f"{type(e).__name__}: {e}",
                "line": line[:200],
            }), flush=True)

    if args.wall_clock:
        # live mode: a client may hold the pipe open while it consumes
        # events, so never block on readline without serving — multiplex
        # stdin readiness with event processing
        import select

        eof = False
        while not eof:
            ready, _, _ = select.select([sys.stdin], [], [], 0.02)
            if ready:
                line = sys.stdin.readline()
                if not line:
                    eof = True
                elif line.strip():
                    submit_line(line.strip())
            else:
                session.poll()
    else:
        for line in sys.stdin:
            if line.strip():
                submit_line(line.strip())
    session.drain()
    res = session.close()
    print(json.dumps({
        "event": "summary",
        **res.metrics.row(),
        **session.streaming.row(),
        "backend": args.backend,
        "n_faults": res.n_faults,
        "n_recovered": res.n_recovered,
        "n_lost": res.n_lost,
        "n_transfer_retries": res.n_transfer_retries,
    }), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced CPU-runnable model variant")
    ap.add_argument("--backend", default="sim",
                    choices=["sim", "engine"],
                    help="execution plane: event simulator or the real "
                         "engine (same scheduler either way)")
    ap.add_argument("--device", default="cuda",
                    help="engine plane: device of the replicas (cuda "
                         "unless named; raises without a card)")
    ap.add_argument("--policy", default="hyperflexis",
                    choices=["hyperflexis", "rr", "scorpio", "aladdin",
                             "sa"])
    ap.add_argument("--tasks", default="4task",
                    choices=["2task", "4task"])
    ap.add_argument("--qps", type=float, default=64.0)
    ap.add_argument("--n-per-task", type=int, default=300)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--mode", default="collocated",
                    choices=["collocated", "pd"])
    ap.add_argument("--n-prefill", type=int, default=2)
    ap.add_argument("--n-decode", type=int, default=2)
    ap.add_argument("--one-shot-pd", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--max-workers", type=int, default=4)
    ap.add_argument("--weight-strategy", default="d2d",
                    choices=["d2d", "cpu", "disk", "auto"],
                    help="scale-out weight transport (Table 2); d2d "
                         "falls back to disk with no live donor, auto "
                         "picks the cheapest by measured cost")
    ap.add_argument("--live-migration", action="store_true",
                    help="decode-to-decode live migration: rescue "
                         "predicted-TPOT-miss requests onto less-loaded "
                         "instances and evacuate scale-in / role-flip "
                         "targets instead of draining them")
    ap.add_argument("--priority-mapping", action="store_true")
    ap.add_argument("--monitor-interval", type=float, default=0.05)
    ap.add_argument("--scale-interval", type=float, default=1.0)
    # chunked prefill (sim plane): prompt tokens per prefill step;
    # the engine plane chunks natively via --chunk-size
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="sim plane: bound prompt tokens per prefill "
                         "step (None = monolithic prefill)")
    # prefix cache (both planes): page-level KV reuse across requests
    ap.add_argument("--prefix-cache", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="reuse cached KV pages across requests with "
                         "shared prefixes (engine: per-replica page "
                         "cache; sim: cluster-shared prefix index)")
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    help="cap the prefix cache footprint in pages "
                         "(None = bounded by the page pool)")
    # shared-prefix workload (the prefix-cache stressor)
    ap.add_argument("--workload", default="poisson",
                    choices=["poisson", "shared-prefix"],
                    help="batch workload generator; shared-prefix "
                         "draws Zipfian prefix groups (chat shape)")
    ap.add_argument("--prefix-groups", type=int, default=8,
                    help="shared-prefix: number of Zipfian groups")
    ap.add_argument("--prefix-len", type=int, default=64,
                    help="shared-prefix: shared tokens per group")
    # engine-plane knobs (only read with --backend engine)
    ap.add_argument("--engine-slots", type=int, default=8)
    ap.add_argument("--engine-max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16,
                    help="engine plane: KV page size (tokens)")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="engine plane: static prefill-chunk ceiling")
    ap.add_argument("--decode-block", type=int, default=8,
                    help="engine plane: max fused decode iterations "
                         "per dispatch (1 = per-token stepping)")
    # speculative decoding (both planes)
    ap.add_argument("--spec-decode", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="SLO-customized speculative decoding: n-gram "
                         "drafter + one-dispatch verify on the engine "
                         "plane, acceptance-rate-scaled decode ticks "
                         "on the sim plane; per-lane depth from each "
                         "request's TPOT slack")
    ap.add_argument("--max-spec-len", type=int, default=8,
                    help="speculation depth ceiling per lane")
    ap.add_argument("--spec-accept-rate", type=float, default=0.7,
                    help="sim plane: modeled per-token acceptance "
                         "probability for speculative proposals")
    ap.add_argument("--clip-prompt", type=int, default=None,
                    help="clip workload prompt lengths (engine smoke "
                         "runs: Table-1 prompts exceed reduced caches)")
    ap.add_argument("--clip-output", type=int, default=None,
                    help="clip workload output lengths")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    # online session mode (JSONL in/out; see module docstring)
    ap.add_argument("--online", action="store_true",
                    help="read JSONL requests from stdin, stream JSONL "
                         "events to stdout (ServingSession front door)")
    ap.add_argument("--admission", default="reject",
                    choices=["none", "reject", "degrade"],
                    help="online mode: submit-time Eq. 5 admission "
                         "policy (reject doomed requests, renegotiate "
                         "their SLO, or queue everything)")
    ap.add_argument("--wall-clock", action="store_true",
                    help="online mode: pace event processing against "
                         "real time instead of the virtual clock")
    # fault tolerance (see repro.core.faults for the spec grammar)
    ap.add_argument("--fault-schedule", default=None,
                    help="deterministic fault spec, e.g. "
                         "'crash:wid=1,t=2.0;kv_drop:p=0.5,max=3;"
                         "weight_fail:strategy=d2d,p=1.0'; seeded by "
                         "--seed so runs replay bit-for-bit")
    ap.add_argument("--recovery", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="replica-failure recovery and transfer retry "
                         "(--no-recovery is the ablation: crashes shed "
                         "their residents instead of re-queueing)")
    args = ap.parse_args(argv)

    task_set = FOUR_TASK_SET if args.tasks == "4task" else TWO_TASK_SET
    model = (get_smoke_config(args.model) if args.smoke
             else get_config(args.model))
    mapper = None
    if args.priority_mapping:
        mapper = PrioritySLOMapper(
            bands_from_tasks([TASKS[t] for t in task_set])
        )
    engine_cfg = None
    if args.backend == "engine":
        from repro_torch.serving.engine import EngineConfig

        engine_cfg = EngineConfig(
            n_slots=args.engine_slots, max_len=args.engine_max_len,
            page_size=args.page_size, chunk_size=args.chunk_size,
            decode_block=args.decode_block,
        )  # spec_decode is applied via the ClusterConfig override
    cfg = ClusterConfig(
        model=model,
        n_workers=args.workers,
        policy=args.policy,
        backend=args.backend,
        engine=engine_cfg,
        mode=args.mode,
        n_prefill=args.n_prefill,
        n_decode=args.n_decode,
        one_shot_pd=args.one_shot_pd,
        scaling=args.scaling,
        scaler=ScalerConfig(tau=args.scale_interval,
                            max_workers=args.max_workers,
                            weight_strategy=args.weight_strategy),
        monitor_interval=args.monitor_interval,
        chunk_tokens=args.chunk_tokens,
        prefix_cache=args.prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages,
        spec_decode=args.spec_decode,
        max_spec_len=args.max_spec_len,
        spec_accept_rate=args.spec_accept_rate,
        live_migration=args.live_migration,
        tp=args.tp,
        seed=args.seed,
        slo_mapper=mapper,
        faults=(FaultInjector.from_spec(args.fault_schedule,
                                        seed=args.seed)
                if args.fault_schedule else None),
        recovery=args.recovery,
    )
    if args.online:
        run_online(args, cfg)
        return
    if args.workload == "shared-prefix":
        reqs = shared_prefix_workload(
            task=task_set[0], n=args.n_per_task * len(task_set),
            qps=args.qps, seed=args.seed, n_groups=args.prefix_groups,
            prefix_len=args.prefix_len,
            suffix_len=max(1, args.prefix_len // 2),
        )
    else:
        reqs = poisson_workload(
            task_set, qps=args.qps, n_per_task=args.n_per_task,
            seed=args.seed, use_priority=args.priority_mapping,
        )
    for r in reqs:
        if args.clip_prompt:
            r.l_in = min(r.l_in, args.clip_prompt)
        if args.clip_output:
            r.l_out = min(r.l_out, args.clip_output)
    res = Cluster(cfg, device=args.device).run(reqs)
    m = res.metrics
    if args.json:
        # RunMetrics.row() is the canonical schema (identical for sim
        # and engine runs, incl. the per-task SLO breakdown)
        print(json.dumps({
            **m.row(),
            "backend": args.backend,
            "scale_out": res.n_scale_out,
            "scale_in": res.n_scale_in,
            "role_flips": res.n_role_flips,
            "live_migrations": res.n_live_migrations,
            "n_faults": res.n_faults,
            "n_recovered": res.n_recovered,
            "n_lost": res.n_lost,
            "n_transfer_retries": res.n_transfer_retries,
            "recovery_latency_s": res.recovery_latency_s,
            "spec_dispatches": res.spec_dispatches,
            "spec_proposed": res.spec_proposed,
            "spec_accepted": res.spec_accepted,
        }))
        return
    print(f"policy={args.policy} backend={args.backend} mode={args.mode} "
          f"qps={args.qps} workers={args.workers} scaling={args.scaling}")
    print(f"  attainment      {m.attainment:.3f} "
          f"(ttft {m.ttft_attainment:.3f}, tpot {m.tpot_attainment:.3f})")
    print(f"  mean E2E        {m.mean_e2e:.2f}s   p99 {m.p99_e2e:.2f}s")
    print(f"  cost            {m.cost_units:.0f} units "
          f"(makespan {m.makespan:.1f}s)")
    if args.prefix_cache:
        print(f"  prefix cache    hit_rate {m.prefix_hit_rate:.3f} "
              f"({m.prefix_hit_tokens} tokens reused)")
    if args.spec_decode:
        tpd = (1.0 + res.spec_accepted / res.spec_dispatches
               if res.spec_dispatches else 1.0)
        print(f"  spec decode     dispatches={res.spec_dispatches} "
              f"proposed={res.spec_proposed} "
              f"accepted={res.spec_accepted} "
              f"tokens/dispatch={tpd:.2f}")
    for t, v in m.per_task.items():
        print(f"    {t:20s} att={v['attainment']:.3f} "
              f"(ttft {v['ttft_attainment']:.3f} / "
              f"tpot {v['tpot_attainment']:.3f}) "
              f"e2e={v['mean_e2e']:.2f}s ttft={v['mean_ttft']:.3f}s")
    if args.scaling:
        print(f"  scaling: out={res.n_scale_out} in={res.n_scale_in} "
              f"role_flips={res.n_role_flips}")
    if args.live_migration:
        print(f"  live migration: landed={res.n_live_migrations} "
              f"(rescue={res.n_rescues} evac={res.n_evacuations}) "
              f"migrated_reqs={m.n_migrated}")
    if args.fault_schedule:
        print(f"  faults: injected={res.n_faults} "
              f"recovered={res.n_recovered} lost={res.n_lost} "
              f"transfer_retries={res.n_transfer_retries} "
              f"(recovery={'on' if args.recovery else 'off'})")
    for t, wid, ev in res.timeline[:20]:
        print(f"    t={t:7.2f}s worker{wid} {ev}")


if __name__ == "__main__":
    main()
