"""The dense Qwen1.5 decoder (transformers' ``Qwen2ForCausalLM``): the
weights the benchmark draws for it, the port's model built on them, and
the FLOPs and bytes a step of it needs.

Weights: a tensor per kind of weight with every layer stacked on the
first axis; matrices are ``(in, out)`` (``x @ w``), the head
``(vocab, d)``.  Products' matrices are drawn with std ``1/sqrt(fan_in)``
and the head with ``1/sqrt(d)``, so logits are O(1).  Norm weights are
drawn as the port parameterises them, a ``scale`` applied as
``(1 + scale)``; ``reference/qwen1_5.py`` applies the same.  The head
width is ``hidden_size / num_attention_heads``, as Qwen1.5's config.json
gives no other.

Counts follow ``roofline.py``'s rules: the model's own work for the
real tokens, each input byte once a step.
"""

from __future__ import annotations

import dataclasses

from hfxbench.roofline import causal_keys

# the port's config fields, from the published config.json's keys
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings"}
# stds of the weights that are not products' matrices
EMBED_STD, BIAS_STD, NORM_STD = 1.0, 0.1, 0.1


def shapes(cfg: dict) -> dict[str, tuple]:
    """Every weight's shape, in the order they are drawn."""
    L, d, f, v = (cfg["num_hidden_layers"], cfg["hidden_size"],
                  cfg["intermediate_size"], cfg["vocab_size"])
    hd = d // cfg["num_attention_heads"]
    qd, kvd = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    out = {"embed": (v, d), "final_norm": (d,),
           "wq": (L, d, qd), "wk": (L, d, kvd), "wv": (L, d, kvd),
           "wo": (L, qd, d), "ln1": (L, d), "ln2": (L, d),
           "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d)}
    if cfg["architecture"]["qkv_bias"]:
        out.update(bq=(L, qd), bk=(L, kvd), bv=(L, kvd))
    if not cfg["tie_word_embeddings"]:
        out["head"] = (v, d)
    return out


def std(name: str, shape: tuple) -> float:
    if name == "embed":
        return EMBED_STD
    if name in ("bq", "bk", "bv"):
        return BIAS_STD
    if name in ("ln1", "ln2", "final_norm"):
        return NORM_STD
    return shape[-1] ** -0.5 if name == "head" else shape[-2] ** -0.5


def port_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig

    if cfg["hidden_act"] != "silu" or cfg["architecture"]["family"] != "dense":
        raise ValueError(f"{cfg['name']}: the port serves a dense SwiGLU "
                         f"decoder here, not {cfg['architecture']}")
    kw = {field: cfg[key] for key, field in PORT_FIELDS.items()}
    return ModelConfig(name=cfg["name"], family="dense",
                       qkv_bias=cfg["architecture"]["qkv_bias"],
                       source=cfg["source"], **kw)


def state_dict(cfg: dict, weights: dict) -> dict:
    """The port's parameter names, each mapped to its layer's view of
    the drawn tensors."""
    state = {"embed": weights["embed"], "final_norm": weights["final_norm"]}
    if "head" in weights:
        state["head"] = weights["head"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            if name in weights:
                state[p + "attn." + name] = weights[name][i]
        for name in ("w_gate", "w_up", "w_down"):
            state[p + "ffn." + name] = weights[name][i]
        state[p + "ln1"] = weights["ln1"][i]
        state[p + "ln2"] = weights["ln2"][i]
    return state


@dataclasses.dataclass(frozen=True)
class Dims:
    """What the metric readers count with: every layer alike, every
    weight passed by every token."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    bytes: int = 2    # bf16 weights and KV

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

    def prefill_flops(self, rows: list[tuple[int, int]],
                      n_completed: int) -> float:
        """A chunked-prefill step: rows of (start, take) real prompt
        tokens; the head runs for the rows whose prompt completes."""
        tokens = sum(t for _, t in rows)
        return (2.0 * self.body_params * tokens
                + sum(self.attn_flops(causal_keys(s, t)) for s, t in rows)
                + 2.0 * self.head_params * n_completed)

    def prefill_bytes(self, rows: list[tuple[int, int]]) -> float:
        """Every weight once, and the K and V of every position a row's
        chunk attends to (its own included)."""
        return ((self.body_params + self.head_params) * self.bytes
                + sum(self.kv_bytes_per_token * (s + t) for s, t in rows))

    def decode_iter_flops(self, kv_lens: list[int]) -> float:
        """One decode iteration: one token for each emitting row, which
        attends to ``kv_len`` positions (its own included)."""
        return (2.0 * (self.body_params + self.head_params) * len(kv_lens)
                + sum(self.attn_flops(n) for n in kv_lens))

    def decode_iter_bytes(self, kv_lens: list[int]) -> float:
        return ((self.body_params + self.head_params) * self.bytes
                + self.kv_bytes_per_token * sum(kv_lens))

    def paged_decode_call(self, kv_lens: list[int]) -> tuple[float, float]:
        """(FLOPs, bytes) of one layer's paged decode attention call:
        the K and V of every position each row's ``kv_len`` covers, the
        query and the output of the rows that have any."""
        rows = [n for n in kv_lens if n > 0]
        hd, b = self.head_dim, self.bytes
        kv = 2 * self.kv_heads * hd * b * sum(rows)
        q_out = 2 * self.heads * hd * b * len(rows)
        flops = 4 * self.heads * hd * sum(rows)
        return float(flops), float(kv + q_out)

    def paged_decode_calls(self, kv_lens: list[int]) -> list[tuple]:
        """(FLOPs, bytes) of each paged decode attention call of one
        decode iteration: one a layer, every layer alike."""
        return [self.paged_decode_call(kv_lens)] * self.layers


def counts(cfg: dict) -> Dims:
    h = cfg["num_attention_heads"]
    return Dims(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
                heads=h, kv_heads=cfg["num_key_value_heads"],
                head_dim=cfg["hidden_size"] // h,
                ff=cfg["intermediate_size"], vocab=cfg["vocab_size"])
