"""Closed-loop online serving client over the PyTorch port's ServingSession.

The port's counterpart of ``examples/online_serving.py``.  Each of N
clients keeps exactly one request in flight: it submits, consumes the
typed event stream (ADMITTED -> FIRST_TOKEN -> TOKEN... -> FINISHED) as
the tokens are generated, and only then submits its next round — arrival
stamped at the previous response's finish time, i.e. a genuine closed
loop over the cluster's clock.

    PYTHONPATH=src python examples/online_serving_torch.py            # sim
    PYTHONPATH=src python examples/online_serving_torch.py --smoke    # engine

``--smoke`` runs the reduced engine config (the CI configuration).  The
engine plane runs on the CUDA card unless ``--device`` names another (it
raises without a card); the ``Cluster`` draws its seed weights on the
device from its config's seed (``models.build.seeded_model``).  The sim
plane needs no device.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.request import TASKS
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.session import EventKind, ServingSession


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="sim", choices=["sim", "engine"])
    ap.add_argument("--model", default="qwen7b")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--admission", default="reject",
                    choices=["none", "reject", "degrade"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced engine config (CI smoke run)")
    ap.add_argument("--device", default="cuda",
                    help="device of the engine plane (default: the card)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.backend = "engine"
        args.clients = min(args.clients, 2)
        args.rounds = min(args.rounds, 2)

    engine_cfg = None
    engine_kw = {}
    if args.backend == "engine":
        from repro_torch.serving.engine import EngineConfig

        engine_cfg = EngineConfig.smoke()
        model = get_smoke_config(args.model)
        engine_kw = dict(device=args.device)
    else:
        model = get_config(args.model)
    cfg = ClusterConfig(model=model, backend=args.backend,
                        engine=engine_cfg, n_workers=1, seed=args.seed)
    session = ServingSession(Cluster(cfg, **engine_kw),
                             admission=args.admission)

    rng = np.random.default_rng(args.seed)
    specs = [TASKS["gsm8k"], TASKS["sharegpt"]]

    def submit(cid: int):
        spec = specs[cid % len(specs)]
        if args.backend == "engine":
            l_in = int(rng.integers(4, 16))
            l_out = int(rng.integers(2, 6))
        else:
            l_in, l_out = spec.sample_lengths(rng)
        return session.submit(
            l_in=l_in, l_out=l_out, task=spec.name,
            ttft_slo=spec.ttft_slo, tpot_slo=spec.tpot_slo,
        )  # arrival=None -> stamped "now": the closed loop

    active = {cid: submit(cid) for cid in range(args.clients)}
    rounds_left = {cid: args.rounds - 1 for cid in active}
    n_rejected = 0
    rounds = []                 # (client, task, tokens) in order
    while active:
        for cid in list(active):
            h = active[cid]
            n_tok = 0
            for ev in h.events():     # drives the event loop
                if ev.kind in (EventKind.FIRST_TOKEN, EventKind.TOKEN):
                    n_tok += 1
            r = h.request
            rounds.append((cid, r.task, n_tok))
            if h.rejected:
                n_rejected += 1
                print(f"client {cid}: REJECTED "
                      f"({h.log[-1].data.get('reason', '?')})")
            elif not h.done:
                # stream ended without a terminal event: the drain
                # deadline expired with the request still unplaced
                print(f"client {cid}: STALLED ({r.task}, never served)")
                del active[cid]
                continue
            else:
                print(f"client {cid}: {r.task:9s} {n_tok:3d} tokens  "
                      f"ttft={r.ttft:.4f}s  e2e={r.e2e:.4f}s  "
                      f"attained={r.attained()}")
            if rounds_left[cid] > 0:
                rounds_left[cid] -= 1
                active[cid] = submit(cid)
            else:
                del active[cid]

    session.drain()
    res = session.close()
    m = res.metrics
    print(f"\n{args.clients} clients x {args.rounds} rounds "
          f"(backend={args.backend}, admission={args.admission}):")
    print(f"  attainment {m.attainment:.3f}  finished {m.n_finished}/"
          f"{m.n_total}  rejected {m.n_rejected}")
    s = session.streaming.row()
    print(f"  TTFB mean={s['mean_ttfb']}s p99={s['p99_ttfb']}s   "
          f"ITL mean={s['mean_itl']}s p99={s['p99_itl']}s")
    assert m.n_finished + m.n_rejected == m.n_total
    return {
        "served": m.n_finished,
        "total": m.n_total,
        "rejected": m.n_rejected,
        "rounds": rounds,
        "tokens": {r.rid: list(r.generated or []) for r in res.requests},
    }


if __name__ == "__main__":
    main()
