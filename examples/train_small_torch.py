"""Train a ~100M-param dense LM on the PyTorch port, with checkpointing +
auto-resume (kill it mid-run and start again).

The port's counterpart of ``examples/train_small.py``: the same model
(``SMALL``), data, optimizer and runner settings.  It trains on the CUDA
card unless ``--device`` names another (it raises without a card), with
the plain attention (``use_kernels=False``: no kernel has a backward, in
either package).  ``--ckpt-dir`` defaults to the checkout's git-ignored
``build/train_small_ckpt``; a second run with the same directory resumes
from its latest checkpoint — delete it for a fresh run.

    PYTHONPATH=src python examples/train_small_torch.py --steps 200
    PYTHONPATH=src python examples/train_small_torch.py --steps 20 \
        --batch 2 --seq 32 --device cpu
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.fault_tolerance import RunnerConfig, TrainRunner
from repro_torch.models.build import Model
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig

# ~100M params: 8L d512 8H ff2048 vocab 32k
SMALL = ModelConfig(
    name="small-100m", family="dense", n_layers=8, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=32_000,
)
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[1] / "build" /
                       "train_small_ckpt")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = Model(SMALL, device=device, remat=True, use_kernels=False)
    print(f"params: {SMALL.param_count()/1e6:.1f}M")
    runner = TrainRunner(
        model,
        DataConfig(batch=args.batch, seq_len=args.seq),
        TrainConfig(adamw=AdamWConfig(lr=3e-4, warmup_steps=50),
                    micro_batches=2),
        RunnerConfig(total_steps=args.steps, ckpt_every=50,
                     ckpt_dir=args.ckpt_dir, log_every=20),
    )
    t0 = time.time()
    out = runner.run(torch.Generator(device=device).manual_seed(0))
    seconds = time.time() - t0
    for h in out["history"]:
        print(f"  step {h['step']:4d} loss={h['loss']:.4f} "
              f"|g|={h['grad_norm']:.3f}")
    n = args.steps - out["resumed_from"]
    print(f"{n} steps in {seconds:.1f}s "
          f"(resumed from {out['resumed_from']}); "
          f"final loss {out['final_loss']:.4f}")
    return {
        "history": out["history"],
        "resumed_from": out["resumed_from"],
        "final_loss": out["final_loss"],
        "steps_run": n,
        "seconds": seconds,
        "tokens_per_step": args.batch * args.seq,
    }


if __name__ == "__main__":
    main()
