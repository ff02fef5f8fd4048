"""Peaks of the card and the operations and bytes a step needs, from
shapes alone.

Peaks: NVIDIA's H100 SXM5 data sheet, dense (no sparsity): 989 TFLOP/s
in bf16, 3.35 TB/s of HBM3.  A card set below its 700 W limit runs
slower under load; the run prints the limit beside its numbers.

Counts are of the model's own work for the tokens that are real, not of
what the program computes: a prefill step's padding lanes and a decode
pass's idle rows count nothing.  Each input byte is counted once per
step (weights, the K and V a token attends to), whatever the program
reads again, so a time these give is a lower bound.
"""

from __future__ import annotations

import dataclasses

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    bytes: int = 2    # bf16 weights and KV

    @classmethod
    def of(cls, cfg: dict) -> "Dims":
        h = cfg["num_attention_heads"]
        return cls(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
                   heads=h, kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg["hidden_size"] // h,
                   ff=cfg["intermediate_size"], vocab=cfg["vocab_size"])

    @property
    def layer_params(self) -> int:
        """Weights of one layer's products (Q, K, V, O, gate, up, down)
        and its QKV biases; the norms are elementwise."""
        qd, kvd = self.heads * self.head_dim, self.kv_heads * self.head_dim
        return (self.d * qd + 2 * self.d * kvd + qd * self.d
                + 3 * self.d * self.ff + qd + 2 * kvd)

    @property
    def body_params(self) -> int:
        return self.layers * self.layer_params

    @property
    def head_params(self) -> int:
        return self.vocab * self.d

    @property
    def kv_bytes_per_token(self) -> int:
        """K and V of one position over every layer."""
        return 2 * self.layers * self.kv_heads * self.head_dim * self.bytes

    def attn_flops(self, n_keys: int) -> int:
        """QK^T and PV of one query over ``n_keys`` positions, every layer."""
        return 4 * self.layers * self.heads * self.head_dim * n_keys


def causal_keys(start: int, take: int) -> int:
    """Keys attended by the queries at positions start .. start+take-1
    (a query at position p sees p + 1 of them)."""
    return take * start + take * (take + 1) // 2


def prefill_flops(dims: Dims, rows: list[tuple[int, int]],
                  n_completed: int) -> float:
    """A chunked-prefill step: rows of (start, take) real prompt tokens;
    the head runs for the rows whose prompt completes."""
    tokens = sum(t for _, t in rows)
    return (2.0 * dims.body_params * tokens
            + sum(dims.attn_flops(causal_keys(s, t)) for s, t in rows)
            + 2.0 * dims.head_params * n_completed)


def prefill_bytes(dims: Dims, rows: list[tuple[int, int]]) -> float:
    """Every weight once, and the K and V of every position a row's
    chunk attends to (its own included)."""
    return ((dims.body_params + dims.head_params) * dims.bytes
            + sum(dims.kv_bytes_per_token * (s + t) for s, t in rows))


def decode_iter_flops(dims: Dims, kv_lens: list[int]) -> float:
    """One decode iteration: one token for each emitting row, which
    attends to ``kv_len`` positions (its own included)."""
    return (2.0 * (dims.body_params + dims.head_params) * len(kv_lens)
            + sum(dims.attn_flops(n) for n in kv_lens))


def decode_iter_bytes(dims: Dims, kv_lens: list[int]) -> float:
    return ((dims.body_params + dims.head_params) * dims.bytes
            + dims.kv_bytes_per_token * sum(kv_lens))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S)


def paged_decode_call(dims: Dims, kv_lens: list[int]) -> tuple[float, float]:
    """(FLOPs, bytes) of one paged decode attention call (one layer):
    the K and V of every position each row's ``kv_len`` covers, the
    query and the output of the rows that have any."""
    rows = [n for n in kv_lens if n > 0]
    hd, b = dims.head_dim, dims.bytes
    kv = 2 * dims.kv_heads * hd * b * sum(rows)
    q_out = 2 * dims.heads * hd * b * len(rows)
    flops = 4 * dims.heads * hd * sum(rows)
    return float(flops), float(kv + q_out)
