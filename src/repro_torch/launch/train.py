"""Training launcher of the port (counterpart of ``repro/launch/train.py``).

Runs real steps of a config on one device: a reduced config on the CPU
(``--smoke --device cpu``), or a full-width one on the card (the
default device; it raises without one).  The flags are the JAX
launcher's, plus ``--device``; ``--ckpt-dir`` defaults to the
checkout's git-ignored ``build/train_ckpt``.  It builds
``Model(cfg, remat=True, use_kernels=False)``, the JAX launcher's
``build_model(cfg, remat=True)``: no kernel has a backward in either
package, so attention and the SSD scan take their plain routes.  A
second launch with the same ``--ckpt-dir`` resumes from its latest
checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \
        --smoke --steps 50 --batch 8 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
        --steps 20 --batch 8 --seq 512 --micro-batches 2
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.fault_tolerance import (
    DEFAULT_CKPT_DIR,
    RunnerConfig,
    TrainRunner,
)
from repro_torch.models.build import Model
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    device = resolve_device(args.device)
    model = Model(cfg, device=device, remat=True, use_kernels=False)
    n = cfg.param_count()
    print(f"arch={cfg.name} params={n/1e6:.1f}M "
          f"pattern={cfg.layer_pattern()[:4]}")

    runner = TrainRunner(
        model,
        DataConfig(batch=args.batch, seq_len=args.seq, seed=args.seed),
        TrainConfig(adamw=AdamWConfig(lr=args.lr),
                    micro_batches=args.micro_batches),
        RunnerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, log_every=10),
    )
    t0 = time.time()
    out = runner.run(torch.Generator(device=device).manual_seed(args.seed))
    dt = time.time() - t0
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"|g| {h['grad_norm']:.3f}")
    steps_run = args.steps - out["resumed_from"]
    print(f"done: {steps_run} steps in {dt:.1f}s "
          f"({dt / max(steps_run, 1):.3f} s/step), "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
