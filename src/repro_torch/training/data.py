"""Deterministic, stateless, resumable synthetic data pipeline (copy of
``repro/training/data.py``).

Batches are pure functions of (seed, step): restart/resume needs no
iterator state, a checkpointed step counter is enough — the pipeline is
fault-tolerant and *elastic* by construction (re-sharding the same
global batch across a different worker count yields identical data).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0


def make_batch(cfg: ModelConfig, data: DataConfig, step: int) -> dict:
    """Global batch for `step`, matching the arch's frontend."""
    rng = np.random.default_rng(
        np.random.SeedSequence([data.seed, step, 0xD47A])
    )
    b, s = data.batch, data.seq_len
    if cfg.frontend == "frames":
        frames = rng.standard_normal((b, s, cfg.d_model), np.float32)
        labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        mask = (rng.random((b, s)) < 0.15).astype(np.float32)  # HuBERT-style
        return {"frames": frames, "labels": labels, "mask": mask}
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def batch_spec(cfg: ModelConfig, data: DataConfig) -> dict:
    """Meta tensors matching make_batch's shapes and dtypes (for a
    meta-device dry-run; nothing is allocated)."""
    b, s = data.batch, data.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.frontend == "frames":
        return {
            "frames": meta((b, s, cfg.d_model), torch.float32),
            "labels": meta((b, s), torch.int32),
            "mask": meta((b, s), torch.float32),
        }
    return {
        "tokens": meta((b, s), torch.int32),
        "labels": meta((b, s), torch.int32),
    }
