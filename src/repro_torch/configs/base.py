"""Model configuration for the port (copy of ``repro/configs/base.py``).

Every architecture is a :class:`ModelConfig` holding its published
hyper-parameters plus the *layer pattern* the model builder reads:

- ``dense``        — standard pre-norm GQA transformer block
- ``moe``          — GQA attention + top-k mixture-of-experts FFN
- ``mamba``        — Mamba-2 SSD block (attention free)
- ``local``        — sliding-window (local) GQA attention block
- ``global``       — full (global) GQA attention block
- ``shared_attn``  — a *weight-shared* attention block (Zamba-2 style)
- ``encoder``      — bidirectional (non-causal) attention block

A model is a sequence of *segments* ``(kind, count)``; the port's
``models/build.py`` runs every kind.  The assigned shape suite
(:data:`SHAPES`, ``ModelConfig.shapes()``) and :func:`mfu_flops` are
copied too, for the dry-run tooling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned input-shape suite, identical for every LM architecture)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (seq_len, global_batch) evaluation cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    dispatch_groups: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyper-parameters."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    causal: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    window: int = 0
    local_global_ratio: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_period: int = 0
    frontend: str = "token"
    source: str = ""
    pattern_override: Optional[Tuple[Tuple[str, int], ...]] = None

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch supports very-long-context decode (long_500k):
        SSM and hybrid archs keep O(1) state per token, and gemma3's 5:1
        local:global pattern bounds the quadratic part to 1/6 of its
        layers; pure full-attention archs are skipped."""
        return self.family in ("ssm", "hybrid") or self.local_global_ratio > 0

    def layer_pattern(self) -> Tuple[Tuple[str, int], ...]:
        """Return the segment list ``((kind, count), ...)``."""
        if self.pattern_override is not None:
            return self.pattern_override
        if self.family == "ssm":
            return (("mamba", self.n_layers),)
        if self.family == "hybrid":
            p = self.shared_attn_period
            n_groups = self.n_layers // (p + 1)
            tail = self.n_layers - n_groups * (p + 1)
            segs: list[Tuple[str, int]] = []
            for _ in range(n_groups):
                segs.append(("mamba", p))
                segs.append(("shared_attn", 1))
            if tail:
                segs.append(("mamba", tail))
            return tuple(segs)
        if self.local_global_ratio > 0:
            r = self.local_global_ratio
            n_groups = self.n_layers // (r + 1)
            tail = self.n_layers - n_groups * (r + 1)
            segs = []
            for _ in range(n_groups):
                segs.append(("local", r))
                segs.append(("global", 1))
            if tail:
                segs.append(("local", tail))
            return tuple(segs)
        if self.moe is not None:
            return (("moe", self.n_layers),)
        if self.is_encoder_only:
            return (("encoder", self.n_layers),)
        return (("dense", self.n_layers),)

    def param_count(self) -> int:
        """Exact parameter count, from shapes: attention/FFN layers, or
        Mamba-2 layers (SSM), or Mamba-2 layers plus one weight-shared
        attention block (hybrid)."""
        d, hd = self.d_model, self.resolved_head_dim
        q_dim = self.n_heads * hd
        kv_dim = self.n_kv_heads * hd
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d
        if self.qkv_bias:
            attn += q_dim + 2 * kv_dim
        if self.moe is not None:
            m = self.moe
            ffn = d * m.num_experts + m.num_experts * 3 * d * m.expert_d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_attn_layer = attn + ffn + 2 * d
        if self.family == "ssm":
            body = self.n_layers * (self._mamba_params() + d)
        elif self.family == "hybrid":
            n_mamba = sum(c for k, c in self.layer_pattern() if k == "mamba")
            body = n_mamba * (self._mamba_params() + d) + per_attn_layer
        else:
            body = self.n_layers * per_attn_layer
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return body + embed + head + d

    def _mamba_params(self) -> int:
        s, d = self.ssm, self.d_model
        di, n, h = s.d_inner(d), s.d_state, s.n_heads(d)
        conv_ch = di + 2 * s.n_groups * n
        return (
            d * di  # z (gate) proj
            + d * di  # x proj
            + 2 * d * s.n_groups * n  # B, C proj
            + d * h  # dt proj
            + conv_ch * s.conv_width  # depthwise conv
            + 3 * h  # A_log, D, dt_bias
            + di  # gated rmsnorm
            + di * d  # out proj
        )

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        full_ffn = self.n_layers * m.num_experts * 3 * d * m.expert_d_ff
        act_ffn = self.n_layers * m.top_k * 3 * d * m.expert_d_ff
        return self.param_count() - full_ffn + act_ffn

    def shapes(self) -> Sequence[ShapeSpec]:
        """The shape cells that apply to this architecture (with skips)."""
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
        if not self.is_encoder_only:
            out.append(SHAPES["decode_32k"])
            if self.sub_quadratic:
                out.append(SHAPES["long_500k"])
        return out

    def skipped_shapes(self) -> Sequence[Tuple[str, str]]:
        out = []
        if self.is_encoder_only:
            out.append(("decode_32k", "encoder-only: no decode step"))
            out.append(("long_500k", "encoder-only: no decode step"))
        elif not self.sub_quadratic:
            out.append(
                ("long_500k", "pure full-attention arch: 500k decode skipped")
            )
        return out


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to a CPU-runnable smoke variant of the same family."""
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            capacity_factor=cfg.moe.capacity_factor,
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(
            d_state=16, head_dim=8, expand=2, conv_width=cfg.ssm.conv_width,
            n_groups=1, chunk_size=16,
        )
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads)
    if cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads  # keep MHA archs MHA
    if cfg.family == "hybrid":
        n_layers = 7
    elif cfg.local_global_ratio > 0:
        n_layers = (cfg.local_global_ratio + 1) + 1
    else:
        n_layers = 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=8 if cfg.window else 0,
        moe=moe,
        ssm=ssm,
        shared_attn_period=2 if cfg.family == "hybrid" else 0,
    )


def mfu_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS for the roofline 'useful flops' ratio.

    train:   6 * N_active * tokens  (+3x fwd attention flops)
    prefill: 2 * N_active * tokens  (+1x fwd attention flops)
    decode:  2 * N_active * batch   (one token per sequence)
    """
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        base = 6.0 * n_active * shape.tokens
        attn_mult = 3.0
    elif shape.kind == "prefill":
        base = 2.0 * n_active * shape.tokens
        attn_mult = 1.0
    else:
        base = 2.0 * n_active * shape.global_batch
        attn_mult = 1.0

    # attention flops (QK^T + PV), causal halving for causal archs
    attn = 0.0
    hd = cfg.resolved_head_dim
    for kind, count in cfg.layer_pattern():
        if kind in ("dense", "moe", "global", "encoder", "shared_attn"):
            s_eff = shape.seq_len
        elif kind == "local":
            s_eff = min(cfg.window, shape.seq_len)
        else:  # mamba: linear state update, counted via param flops + state
            continue
        if shape.kind == "decode":
            # one query token attends to the full cache
            flops = 4.0 * shape.global_batch * shape.seq_len * cfg.n_heads * hd
        else:
            causal = 0.5 if cfg.causal else 1.0
            flops = (
                4.0 * shape.global_batch * shape.seq_len * s_eff
                * cfg.n_heads * hd * causal
            )
        attn += count * flops
    return base + attn_mult * attn
